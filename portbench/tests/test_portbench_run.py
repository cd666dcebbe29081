"""A whole run of a toy cell on the CPU: the last line's shape, a sound run,
and the faults a flat search can have, each caught by `correct`."""

import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, run_toy

from portbench.run import FORBIDDEN, forbidden_modules


def test_last_line_shape(toy_bench):
    root, bench = toy_bench
    out = run_toy(root, bench, "toy-int-l2-bf16.toy4")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"qps", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == {"missing", "id_diff", "rank_gap", "score_err"}
    json.dumps(out)


def test_traced_line_shape(toy_bench):
    root, bench = toy_bench
    out = run_toy(root, bench, "toy-f32-cos.toy4", traced=True)
    assert out["correct"] is True
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    # on the CPU there is no device trace and no peak table: only the
    # readers that find something report
    assert "device_idle.batch" not in out["metrics"]
    assert "scan_roofline.batch" not in out["metrics"]
    assert out["metrics"]["api_host_ms.batch"]["value"] > 0
    assert out["metrics"]["insert_s"]["value"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["toy-int-l2-bf16.toy4", "toy-int-l2-bf16.toy1", "toy-f32-cos.toy4",
                                  "toy-f32-cos.toy4f"])
def test_sound_runs_are_correct(toy_bench, cell):
    root, bench = toy_bench
    out = run_toy(root, bench, cell, seed=2**31 + 17)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["missing"]["value"] == 0


def test_fused_path_and_splice_are_correct(toy_bench, monkeypatch):
    """With the fused-scan threshold lowered, the kernels' plain versions
    and the strict fallback's splice run under the same comparison."""
    from vectorindex_tpu_torch.models import flat

    monkeypatch.setattr(flat, "LARGE_SCAN_THRESHOLD", 1024)
    root, bench = toy_bench
    out = run_toy(root, bench, "toy-int-l2-bf16.toy4")
    assert out["correct"] is True, out["checks"]


def _half_batch(orig):
    def search(self, queries, k, *a, **kw):
        q = np.asarray(queries)
        half = orig(self, q[: max(1, len(q) // 2)], k, *a, **kw)
        return (half * 2)[: len(q)]  # the rest answered with the first half's lists
    return search


def _altered_answer(orig):
    def results(self, dist, ids, k):
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % self.count  # the nearest id, produced wrong
        return orig(self, dist, ids, k)
    return results


FAULT_CELLS = [(f, c) for f in ("half_batch", "altered_answer", "dropped_result")
               for c in ("toy-int-l2-bf16.toy4", "toy-f32-cos.toy4", "toy-f32-cos.toy4f")]


@pytest.mark.parametrize("fault,cell", FAULT_CELLS + [("filter_ignored", "toy-f32-cos.toy4f")])
def test_faults_are_caught(toy_bench, monkeypatch, fault, cell):
    from vectorindex_tpu_torch.models.flat import FlatIndex

    if fault == "filter_ignored":
        orig = FlatIndex.batch_search
        monkeypatch.setattr(FlatIndex, "batch_search",
                            lambda self, q, k, *a, allow_ids=None, **kw: orig(self, q, k))
    elif fault == "half_batch":
        monkeypatch.setattr(FlatIndex, "batch_search", _half_batch(FlatIndex.batch_search))
    elif fault == "altered_answer":
        monkeypatch.setattr(FlatIndex, "_results", _altered_answer(FlatIndex._results))
    else:
        orig = FlatIndex.batch_search
        monkeypatch.setattr(FlatIndex, "batch_search",
                            lambda self, q, k, *a, **kw: [r[:-1] for r in orig(self, q, k, *a, **kw)])
    root, bench = toy_bench
    out = run_toy(root, bench, cell)
    assert out["correct"] is False


def test_no_forbidden_module_in_a_run(tmp_path):
    """A whole toy run in a fresh process loads no JAX and no JAX package,
    compared by whole top-level name (the port's name begins with the JAX
    package's)."""
    code = (
        "import sys, time, torch\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
        "from conftest import copy_benchmark, add_toys, run_toy\n"
        f"root = copy_benchmark(Path({str(tmp_path)!r}))\n"
        "out = run_toy(root, add_toys(root), 'toy-int-l2-bf16.toy4')\n"
        "from portbench.run import forbidden_modules\n"
        "assert 'vectorindex_tpu_torch' in sys.modules\n"
        "print(out['correct'], forbidden_modules())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[-2] == "True []"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    """The port's name begins with the JAX package's, and a JAX-like prefix
    is not JAX: only whole top-level names count."""
    import vectorindex_tpu_torch  # noqa: F401

    monkeypatch.setitem(sys.modules, "jaxlibrary.x", sys)
    found = forbidden_modules()
    assert "vectorindex_tpu" not in found and "jax" not in found
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in forbidden_modules()
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "vectorindex_tpu"}


def test_cli_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "bigann10m-flat-bf16.batch256",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT)},
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_cli_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits non-zero and prints no result."""
    from conftest import copy_benchmark

    copy_benchmark(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "bigann10m-flat-bf16.batch256",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _spy_rare_warm(monkeypatch, runner, seen):
    """Record, for each search of set-up's rare-path warm-up, the rare
    path's counter before it."""
    orig = runner._warm_rare_path

    def spy(mod, index, traffic, allow, telem):
        calls, search = [], mod.search
        mod.search = lambda *a: calls.append(telem.snapshot()["counters"].get(mod.RARE_COUNTER, 0)) or search(*a)
        try:
            orig(mod, index, traffic, allow, telem)
        finally:
            mod.search = search
        seen.append(calls)

    monkeypatch.setattr(runner, "_warm_rare_path", spy)


def test_set_up_warms_the_strict_fallback(toy_bench, monkeypatch):
    """Set-up searches until one query takes the strict fallback, and no
    further, in every configuration: where distances tie that is soon, and
    elsewhere it stops after one pass over the pool or WARM_RARE_CALLS
    calls."""
    from vectorindex_tpu_torch.models import flat
    from vectorindex_tpu_torch.utils.telemetry import TELEM

    from portbench import run as runner

    threshold = flat.LARGE_SCAN_THRESHOLD
    monkeypatch.setattr(flat, "LARGE_SCAN_THRESHOLD", 1024)
    seen = []
    _spy_rare_warm(monkeypatch, runner, seen)
    root, bench = toy_bench
    path = root / "portbench" / "configs" / "toy-int-l2-bf16.json"
    cfg = json.loads(path.read_text())
    # components 0..3: distances tie at the 10th in most queries
    cfg["data"].update(center_std=1.0, noise_std=1.0, offset=1.0, clip=[0.0, 3.0])
    path.write_text(json.dumps(cfg))
    out = run_toy(root, bench, "toy-int-l2-bf16.toy4")
    assert out["correct"] is True
    calls = seen[0]
    # the first search finds no fallback yet; the loop ends on the first
    assert calls and calls[0] == 0 and all(c == 0 for c in calls)
    assert len(calls) < 64 // 4
    assert not TELEM.enabled
    # on the plain scan no query falls back: one pass over the 50-query
    # pool, 4 a call
    monkeypatch.setattr(flat, "LARGE_SCAN_THRESHOLD", threshold)
    out = run_toy(root, bench, "toy-f32-cos.toy4")
    assert out["correct"] is True and len(seen[1]) == 13 and not any(seen[1])
    monkeypatch.setattr(runner, "WARM_RARE_CALLS", 5)
    run_toy(root, bench, "toy-f32-cos.toy4")
    assert len(seen[2]) == 5
