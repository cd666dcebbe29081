"""The per-layer metrics that read TELEM's spans over FlatIndex.batch_search
(`results_ms`, `strict_ms`, `scan_self_ms`, `scan_kernel_roofline`): their
entries, and what a traced toy run on the CPU reports of them."""

from conftest import ROOT, run_toy

from portbench.run import HERE, load_benchmark, metric_reader

BENCH = load_benchmark(ROOT)
BATCH = ["bigann10m-flat-bf16.batch256", "cohere1m-flat-f32.batch256"]
SERIAL = ["bigann10m-flat-bf16.serial", "cohere1m-flat-f32.serial"]
#: name: (layer, moves, cells)
SPAN_METRICS = {
    "results_ms.batch": ("index API", "qps", BATCH),
    "strict_ms.batch": ("strict path", "qps", BATCH),
    "scan_self_ms.batch": ("scan kernels", "qps", BATCH),
    "scan_self_ms.serial": ("scan kernels", "latency_p95_ms", SERIAL),
    "scan_kernel_roofline.batch": ("scan kernels", "qps", BATCH),
    "scan_kernel_roofline.serial": ("scan kernels", "latency_p95_ms", SERIAL),
}
#: the metrics that read CUDA events: none on the CPU
DEVICE_SPANS = set(SPAN_METRICS) - {"results_ms.batch"}


def test_span_metrics_are_entries_with_readers():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, (layer, moves, cells) in SPAN_METRICS.items():
        m = entries[name]
        assert (m["source"], m["layer"], m["moves"], m["workloads"]) == ("program_span", layer, moves, cells)
        assert callable(metric_reader(name, HERE))
    # appended after the metrics that were there
    assert [m["name"] for m in BENCH["per_layer"]][-len(SPAN_METRICS):] == list(SPAN_METRICS)


def test_traced_line_carries_the_span_metrics(toy_bench, monkeypatch):
    """On the CPU the results span is read and the device spans are not;
    the host's share of the results is within the call's host time."""
    from vectorindex_tpu_torch.models import flat

    monkeypatch.setattr(flat, "LARGE_SCAN_THRESHOLD", 1024)
    root, bench = toy_bench
    out = run_toy(root, bench, "toy-int-l2-bf16.toy4", traced=True)
    assert out["correct"] is True
    got = out["metrics"]
    assert 0 < got["results_ms.batch"]["value"] <= got["api_host_ms.batch"]["value"]
    assert got["results_ms.batch"]["unit"] == "ms"
    assert not DEVICE_SPANS & set(got)
    serial = run_toy(root, bench, "toy-int-l2-bf16.toy1", traced=True)
    assert serial["correct"] is True
    assert not set(SPAN_METRICS) & set(serial["metrics"])
    assert "api_host_ms.serial" in serial["metrics"]
