"""TELEM's spans over FlatIndex.batch_search and the CUDA-event device spans
on K1, K2 and the strict fallback, on the CPU: which spans a call's record
holds, that the disabled path makes no event and records nothing, the
timers' fractional milliseconds, the device spans' bookkeeping on fake
events, and the benchmark's readers of the spans on synthetic runs."""

import types

import numpy as np
import pytest
import torch

import vectorindex_tpu_torch.models.flat as tflat
from portbench import roofline
from portbench.run import HERE, load_config, metric_reader
from vectorindex_tpu_torch.utils import telemetry
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.telemetry import TELEM, QueryStats, Telemetry

D = 16
HOST_SPANS = {"upload", "score_flat", "fetch", "results"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _index(x, device="cpu"):
    t = tflat.FlatIndex(x.shape[1], Metric.L2, device=device)
    t.insert_batch(list(range(len(x))), x)
    return t


def _traced_search(index, q, k):
    """(results, the QueryStats the recorder saw, the counters)."""
    seen = []
    TELEM.reset()
    TELEM.enable()
    TELEM.register_recorder("spans", seen.append)
    try:
        res = index.batch_search(q, k)
    finally:
        TELEM.disable()
        TELEM.unregister_recorder("spans")
    assert len(seen) == 1
    return res, seen[0], TELEM.snapshot()["counters"]


@pytest.mark.parametrize("route", ["strict", "fused"])
def test_record_holds_the_spans_that_tile_the_call(route, monkeypatch):
    if route == "fused":
        monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2048, D)).astype(np.float32)
    q = rng.standard_normal((5, D)).astype(np.float32)
    res, rec, counters = _traced_search(_index(x), q, 10)
    # the recorder runs after results: the record already holds every span
    assert set(rec.stage_ms) == HOST_SPANS
    assert all(ms >= 0 for ms in rec.stage_ms.values())
    assert "verify_fallback" not in rec.flags and len(res) == 5
    assert {f"time_ms.{s}" for s in HOST_SPANS} <= set(counters)
    assert counters[f"kernel.scan_{route}.calls"] == 1


def test_fallback_record_holds_rerank(monkeypatch):
    """Integer rows 0..3 tie at the 10th distance in most queries: K2's count
    sends them down the strict fallback, timed by the rerank span."""
    monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(11)
    x = rng.integers(0, 4, (2048, D)).astype(np.float32)
    q = rng.integers(0, 4, (6, D)).astype(np.float32)
    _, rec, counters = _traced_search(_index(x), q, 10)
    assert set(rec.stage_ms) == HOST_SPANS | {"rerank"}
    assert "verify_fallback" in rec.flags
    assert counters["flat.verify_fallback"] >= 1
    assert counters["kernel.scan_strict.calls"] == 1 and counters["kernel.scan_fused.calls"] == 1
    assert not any(name.startswith("dev.") for name in rec.stage_ms)  # CPU tensors


def test_disabled_telemetry_makes_no_event_and_records_nothing(monkeypatch):
    def no_event(*a, **kw):
        raise AssertionError("a CUDA event was made with TELEM disabled")

    made = []

    class SpyStats(QueryStats):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(tflat, "QueryStats", SpyStats)
    monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(11)
    x = rng.integers(0, 4, (2048, D)).astype(np.float32)
    q = rng.integers(0, 4, (6, D)).astype(np.float32)
    TELEM.reset()
    assert not TELEM.enabled
    _index(x).batch_search(q, 10)
    assert made and all(st.stage_ms == {} for st in made)
    snap = TELEM.snapshot()
    assert snap["counters"] == {} and snap["recent_queries"] == 0
    # off: each span is the one shared null context, whatever its device
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert TELEM.timer("upload") is telemetry._NULL
    assert TELEM.call(QueryStats()) is telemetry._NULL
    assert TELEM.device_span("k1", on_card) is telemetry._NULL


class _FakeEvent:
    """Stands in for torch.cuda.Event: elapsed_time reads `ms`."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.recorded, self.done, self.ms = 0, True, 0.25

    def record(self, stream=None):
        self.recorded += 1

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert end.done
        return self.ms


def test_device_spans_read_into_the_open_call(monkeypatch):
    """Inside a call record a device span records two pooled events on the
    tensor's stream and the record's close adds their time as dev.<name>;
    with no record open, or on the CPU, nothing is made; a second call
    reuses the first call's events."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    _FakeEvent.made = 0
    t = Telemetry(enabled=True)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert t.device_span("k1", on_card) is telemetry._NULL  # no call record open
    stats = QueryStats()
    with t.call(stats):
        with t.device_span("k1", on_card):
            pass
        with t.device_span("k2", on_card):
            pass
        with t.device_span("k2", on_card):
            pass
        assert t.device_span("k1", torch.zeros(1)) is telemetry._NULL
    assert stats.stage_ms == {"dev.k1": 0.25, "dev.k2": 0.5}
    assert _FakeEvent.made == 6
    again = QueryStats()
    with t.call(again):
        with t.device_span("strict", on_card):
            pass
    assert again.stage_ms == {"dev.strict": 0.25} and _FakeEvent.made == 6
    # an event not yet complete is not read (reading would wait for it)
    pending = QueryStats()
    with t.call(pending):
        with t.device_span("k1", on_card):
            pass
        t._tls.spans[-1][-1].done = False
    assert pending.stage_ms == {}
    # a call that raises reads nothing and returns its events to the pool
    with pytest.raises(RuntimeError):
        with t.call(QueryStats()):
            with t.device_span("k1", on_card):
                raise RuntimeError("fault")
    assert t._tls.spans is None and _FakeEvent.made == 6


def test_timer_accumulates_fractional_milliseconds(monkeypatch):
    """Ten 0.3 ms spans add 3 ms to time_ms.<stage> (whole milliseconds a
    call would add 0)."""
    clock = iter(np.arange(20) * 0.3e-3)
    monkeypatch.setattr(telemetry, "time", types.SimpleNamespace(perf_counter=lambda: float(next(clock)),
                                                                 time=lambda: 0.0))
    t = Telemetry(enabled=True)
    stats = QueryStats()
    for _ in range(10):
        with t.timer("results", stats):
            pass
    assert t.snapshot()["counters"]["time_ms.results"] == pytest.approx(3.0)
    assert stats.stage_ms["results"] == pytest.approx(3.0)
    assert t.snapshot()["stage_histograms_us"]["results"] == {"<512us": 10}


# --- the benchmark's readers of the spans ------------------------------------

KIND = "NVIDIA H100 80GB HBM3"
BIGANN = load_config("bigann10m-flat-bf16", HERE)
LEAST = {n: roofline.least_seconds(KIND, 10_000_000, 128, "bfloat16", n, 10)[0] for n in (1, 256)}
CALLS = [
    {"upload": 0.2, "score_flat": 9.0, "fetch": 0.3, "results": 6.0, "dev.k1": 5.0, "dev.k2": 2.5},
    {"upload": 0.2, "score_flat": 10.0, "fetch": 0.3, "rerank": 12.0, "results": 7.0,
     "dev.k1": 5.5, "dev.k2": 2.5, "dev.strict": 8.0},
    {"upload": 0.1, "score_flat": 3.0, "fetch": 0.1, "results": 0.1, "dev.k1": 1.5, "dev.k2": 1.0},
]
SIZES = [256, 256, 1]
WANT = {
    "results_ms.batch": (6.0 + 7.0 + 0.1) / 3,
    "strict_ms.batch": 8.0 / 3,
    "scan_self_ms.batch": (1.5 + 2.0 + 0.5) / 3,
    "scan_self_ms.serial": (1.5 + 2.0 + 0.5) / 3,
    "scan_kernel_roofline.batch": 100 * (2 * LEAST[256] + LEAST[1]) / (18.0e-3),
    "scan_kernel_roofline.serial": 100 * (2 * LEAST[256] + LEAST[1]) / (18.0e-3),
}


def _run(stage_ms, sizes=SIZES, **kw):
    base = dict(cfg=BIGANN, kind=KIND, batch=256, k=10, calls=len(stage_ms), sizes=sizes,
                call_s=[0.02] * len(stage_ms), stage_ms=stage_ms, flags=[set()] * len(stage_ms),
                counters={}, trace={"busy_s": 1.0, "window_s": 2.0})
    base.update(kw)
    return types.SimpleNamespace(**base)


def _value(got):
    return got[0] if isinstance(got, tuple) else got


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_on_a_synthetic_run(name):
    read = metric_reader(name, HERE)
    assert _value(read(_run(CALLS))) == pytest.approx(WANT[name])
    # the CPU's spans (and a program without device spans): host spans alone
    host_only = [{s: ms for s, ms in c.items() if not s.startswith("dev.")} for c in CALLS]
    got = read(_run(host_only))
    if name == "results_ms.batch":
        assert got == pytest.approx(WANT[name])
        # a program whose calls have no results span
        assert read(_run([{"score_flat": 9.0}] * 3)) is None
    else:
        assert got is None
    assert read(_run([], sizes=[])) is None


def test_strict_reads_zero_where_no_query_fell_back():
    calls = [{s: ms for s, ms in c.items() if s not in ("dev.strict", "rerank")} for c in CALLS]
    assert metric_reader("strict_ms.batch", HERE)(_run(calls)) == 0.0


def test_kernel_roofline_is_at_least_the_span_roofline():
    """K1 and K2's time lies inside the score_flat span, so the kernels'
    share reads at or above the span's; the note names the bound."""
    run = _run(CALLS)
    kernels, note = metric_reader("scan_kernel_roofline.batch", HERE)(run)
    span, _ = metric_reader("scan_roofline.batch", HERE)(run)
    assert kernels >= span and "bytes" in note
    assert metric_reader("scan_kernel_roofline.batch", HERE)(_run(CALLS, kind="cpu")) is None
    other = _run(CALLS, cfg={"index": {"type": "ivf"}})
    assert metric_reader("scan_kernel_roofline.batch", HERE)(other) is None
