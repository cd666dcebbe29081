"""Benchmark harness: per-index suites with recall-vs-truth + latency stats.

Parity target: reference VectorIndexBenchmarks (main.swift:140-368) —
  - per-index suites measuring buildSeconds / optimizeSeconds / searchAvg /
    P95 ms / recallAvg / QPS (:214-226)
  - brute-force ground truth per query (:310-320), recall@k (:409)
  - progress streaming as JSON events (:54, :194-196)
  - VectorBench-schema JSON output (Benchmarking/Models.swift:8-60) with
    host metadata (:417-457)

Searches run *batched* (the production shape); per-query latency derives
from batch latency. `search_p95_ms` is, as in the JAX package, the 95th
percentile of the trials' mean per-query times (3 trials), not a latency
percentile. Host metadata names the torch build and the card (its name and
power limit from nvidia-smi). Everything runs on `device` ("cuda" unless
the caller asks for "cpu"); a CUDA device with no card visible raises.
"""

from __future__ import annotations

import json
import platform
import subprocess
import sys
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from vectorindex_tpu_torch.bench import datagen
from vectorindex_tpu_torch.bench.timing import resolve_device
from vectorindex_tpu_torch.utils.config import Metric

SCHEMA_VERSION = 1
#: corpus rows scored at once by brute_force_topk (manhattan and chebyshev
#: also chunk their [B, rows, d] broadcast inside ops/scoring)
TRUTH_ROW_CHUNK = 1 << 20


@dataclass
class BenchResult:
    """Mirrors reference BenchResult (main.swift:373-387)."""

    index: str
    n: int
    d: int
    k: int
    queries: int
    metric: str
    build_seconds: float = 0.0
    optimize_seconds: float = 0.0
    search_avg_ms: float = 0.0
    search_p95_ms: float = 0.0
    qps: float = 0.0
    recall_avg: float = 0.0
    params: dict = field(default_factory=dict)


@dataclass
class BenchRun:
    """VectorBench-style run envelope (Benchmarking/Models.swift:8-60)."""

    schema_version: int
    created_at: str
    host: dict
    results: list


def gpu_name_and_power() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_metadata(device="cuda") -> dict:
    """Host and device info (reference sysctl metadata, main.swift:417-457):
    the torch build, the devices of `device`'s type and, on the card, its
    name and power limit. A failing query raises."""
    dev = resolve_device(device)
    meta = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "processor": platform.processor() or platform.machine(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if dev.type == "cuda":
        meta["devices"] = [
            f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())
        ]
        meta["gpu"] = gpu_name_and_power()
    else:
        meta["devices"] = [str(dev)]
    return meta


def brute_force_topk(x, q, k: int, metric: Metric, device="cuda",
                     row_chunk: int = TRUTH_ROW_CHUNK) -> np.ndarray:
    """Ground truth ids [Q, k] (reference truthTopK, main.swift:310-320):
    full-f32 distances (ops/scoring.distance_block; the L2 dot trick) over
    row chunks of x on `device`, merged in the strict (score, id) order
    (bench/synth.topk_chunked). Memory is bounded by the chunk, not by
    Q·n·d."""
    from vectorindex_tpu_torch.bench.synth import topk_chunked
    from vectorindex_tpu_torch.ops import scoring

    _, ids = topk_chunked(np.asarray(q, dtype=np.float32), x, k,
                          lambda qd, xc: scoring.distance_block(qd, xc, metric),
                          row_chunk=row_chunk, device=device)
    return ids.cpu().numpy()


def recall_at_k(results: list, truth: np.ndarray, id_of: Callable[[int], object]) -> float:
    """recall@k vs truth ids (reference :409)."""
    hits, total = 0, 0
    for b, row in enumerate(results):
        want = {id_of(int(i)) for i in truth[b]}
        hits += len({r.id for r in row} & want)
        total += len(want)
    return hits / max(total, 1)


def _emit(event: dict, progress: bool) -> None:
    if progress:
        print(json.dumps(event), file=sys.stderr, flush=True)


def bench_index(
    make_index: Callable[[], object],
    name: str,
    n: int,
    d: int,
    k: int,
    n_queries: int,
    metric: Metric = Metric.L2,
    seed: int = 42,
    trials: int = 3,
    batch: Optional[int] = None,
    params: Optional[dict] = None,
    progress: bool = False,
    device="cuda",
) -> BenchResult:
    """One suite: build → optimize → timed batched search → recall.
    make_index() builds the index on `device`; the truth is computed there
    too. Each timed call returns host results, so the wall clock covers the
    device's work."""
    resolve_device(device)
    x = datagen.generate(n, d, seed=seed)
    q = datagen.queries_from(x, n_queries, seed=seed + 1)
    ids = [f"v{i}" for i in range(n)]

    idx = make_index()
    _emit({"event": "build_start", "index": name, "n": n}, progress)
    t0 = time.perf_counter()
    idx.insert_batch(ids, x)
    build_s = time.perf_counter() - t0
    _emit({"event": "build_done", "seconds": build_s}, progress)

    t0 = time.perf_counter()
    idx.optimize()
    opt_s = time.perf_counter() - t0
    if opt_s > 1e-4:
        _emit({"event": "optimize_done", "seconds": opt_s}, progress)

    b = batch or n_queries
    # warm (first launches, kernel build)
    results = idx.batch_search(q[:b], k)
    lat = []
    for _ in range(trials):
        t0 = time.perf_counter()
        out = []
        for c in range(0, n_queries, b):
            out.extend(idx.batch_search(q[c : c + b], k))
        lat.append((time.perf_counter() - t0) / n_queries)
    results = out
    lat_ms = np.asarray(lat) * 1e3
    truth = brute_force_topk(x, q, k, metric, device=device)
    rec = recall_at_k(results, truth, lambda i: f"v{i}")
    per_q = float(lat_ms.mean())
    res = BenchResult(
        index=name,
        n=n,
        d=d,
        k=k,
        queries=n_queries,
        metric=metric.value,
        build_seconds=round(build_s, 4),
        optimize_seconds=round(opt_s, 4),
        search_avg_ms=round(per_q, 4),
        search_p95_ms=round(float(np.percentile(lat_ms, 95)), 4),
        qps=round(1e3 / per_q, 1),
        recall_avg=round(rec, 4),
        params=params or {},
    )
    _emit({"event": "suite_done", **asdict(res)}, progress)
    return res


def make_run(results: list, device="cuda") -> BenchRun:
    return BenchRun(
        schema_version=SCHEMA_VERSION,
        created_at=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        host=host_metadata(device),
        results=[asdict(r) for r in results],
    )
