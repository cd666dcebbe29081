#!/usr/bin/env python3
"""Where an HNSW search's time goes on one GPU, and the query upload A/B of its stream.

    python3 scripts/profile_hnsw_torch.py [--rounds 2]

Builds chip_smoke.py's HNSW main path (bench.py's bench_hnsw: HNSWIndex over
lowdim_corpus(100,000, 128, dz=16, seed=41) at HNSWConfig() defaults,
L2) and prints, in one process on one card:

  - the card's name and power limit, the build's seconds;
  - for one warm device_search at B=256 and at B=8 (queries on the card):
    CUDA-event ms, the profiler's kernel launches and device busy ms, the
    idle share, host ms per launch, and the ten operators with the most
    device time;
  - in `--rounds` rounds (forward, then reversed): batch_search walls at
    B=256 (4 batches) and B=8 (8 calls), and batch_search_stream over 8
    batches of 256 (lookahead 3), each with the queries uploaded from
    pinned memory (the index's `_upload_queries`) and from pageable memory
    (a pageable upload synchronises the stream, so no search is enqueued
    behind another).

Last, one JSON line of every figure. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    HNSW_BATCH, HNSW_DIM, HNSW_DZ, HNSW_LOOKAHEAD, HNSW_ROWS, HNSW_SEED, HNSW_STREAM, MAIN_K,
    SMALL_BATCH, gpu_name_and_power, time_ms,
)
from vectorindex_tpu_torch.bench.synth import lowdim_corpus, lowdim_queries  # noqa: E402
from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex  # noqa: E402
from vectorindex_tpu_torch.utils.config import Metric  # noqa: E402


def pageable_queries(self, q):
    return torch.from_numpy(np.ascontiguousarray(self._to_graph_space(q, query=True))).to(self.device)


UPLOADS = {"pinned": HNSWIndex._upload_queries, "pageable": pageable_queries}


def profile_search(idx, q_dev, k: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev_ms = time_ms(lambda: idx.device_search(q_dev, k), 5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        idx.device_search(q_dev, k)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches = sum(1 for e in dev if not e.name.startswith(("Memcpy", "Memset")))
    busy = sum(e.device_time_total for e in dev) / 1e3
    by_op = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA), key=lambda t: -t[1])[:10]
    return {"events_ms": ev_ms, "launches": launches, "busy_ms": busy,
            "idle_share": 1.0 - busy / ev_ms, "host_us_per_launch": 1e3 * ev_ms / launches,
            "top_ops": [{"op": k_[:80], "device_ms": t, "count": c} for k_, t, c in by_op]}


def walls_ms(idx, batches, k: int) -> list:
    out = []
    for qb in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.batch_search(qb, k)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def stream_qps(idx, batches, k: int) -> float:
    list(idx.batch_search_stream(batches[:2], k, lookahead=HNSW_LOOKAHEAD))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(idx.batch_search_stream(batches, k, lookahead=HNSW_LOOKAHEAD))
    return len(batches) * batches[0].shape[0] / (time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gpu = gpu_name_and_power()
    print(f"gpu: {gpu}", flush=True)
    k, bsz = MAIN_K, HNSW_BATCH
    x, W = lowdim_corpus(HNSW_ROWS, HNSW_DIM, dz=HNSW_DZ, seed=HNSW_SEED)
    qs = lowdim_queries(W, bsz * (4 + HNSW_STREAM))
    idx = HNSWIndex(HNSW_DIM, Metric.L2, HNSWConfig(), device="cuda")
    t0 = time.perf_counter()
    idx.insert_batch(list(range(HNSW_ROWS)), x)
    idx.statistics()
    torch.cuda.synchronize()
    out = {"gpu": gpu, "build_s": time.perf_counter() - t0}
    print(f"build {out['build_s']:.2f} s", flush=True)
    for b in (bsz, SMALL_BATCH):
        p = profile_search(idx, torch.from_numpy(qs[:b]).cuda(), k)
        out[f"device_search_B{b}"] = p
        print(f"device_search B={b}: {p['events_ms']:.4g} ms by events, {p['launches']} launches, "
              f"busy {p['busy_ms']:.4g} ms, idle {p['idle_share']:.3f}, "
              f"{p['host_us_per_launch']:.3g} us a launch; top: "
              + "; ".join(f"{o['op']} {o['device_ms']:.3g} ms x{o['count']}" for o in p["top_ops"][:5]),
              flush=True)
    big = [qs[i * bsz : (i + 1) * bsz] for i in range(4)]
    small = [qs[i * SMALL_BATCH : (i + 1) * SMALL_BATCH] for i in range(8)]
    stream = [qs[(4 + i) * bsz : (5 + i) * bsz] for i in range(HNSW_STREAM)]
    runs = {name: {"b256_ms": [], "b8_ms": [], "stream_qps": []} for name in UPLOADS}
    for r in range(args.rounds):
        for name in (list(UPLOADS) if r % 2 == 0 else list(reversed(UPLOADS))):
            HNSWIndex._upload_queries = UPLOADS[name]
            runs[name]["b256_ms"].append(statistics.median(walls_ms(idx, big, k)))
            runs[name]["b8_ms"].append(statistics.median(walls_ms(idx, small, k)))
            runs[name]["stream_qps"].append(stream_qps(idx, stream, k))
            print(f"round {r} {name}: median B={bsz} {runs[name]['b256_ms'][-1]:.4g} ms, "
                  f"B={SMALL_BATCH} {runs[name]['b8_ms'][-1]:.4g} ms, stream "
                  f"{runs[name]['stream_qps'][-1]:.1f} QPS", flush=True)
    HNSWIndex._upload_queries = UPLOADS["pinned"]
    out["uploads"] = runs
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
