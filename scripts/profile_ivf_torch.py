#!/usr/bin/env python3
"""Where the time of vectorindex_tpu_torch's IVF search goes, on one GPU.

    python3 scripts/profile_ivf_torch.py [--batches 5]

Builds the IVF main path of chip_smoke.py (1,000,000 x 128 lowdim corpus,
IVFIndex nlist=1024, bf16 storage, optimize()), then for B=8 at nprobe 32
and 8 and for B=256 at nprobe 32: the median wall time of batch_search over
20 calls, and a torch.profiler trace of `--batches` calls, printed as the
device time per kernel, the device busy time per batch and the idle share
(1 - busy / median wall). Writes the chrome traces to build/profiles/. Needs
a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    IVF_BIG_BATCH, IVF_DIM, IVF_NLIST, IVF_NPROBE, IVF_NPROBE_LOW, IVF_ROWS, MAIN_K,
    SMALL_BATCH, gpu_name_and_power, lowdim_corpus, lowdim_queries,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_ivf_torch: no CUDA device", file=sys.stderr)
        return 1
    from vectorindex_tpu_torch.models.ivf import IVFConfig, IVFIndex
    from vectorindex_tpu_torch.utils.config import Metric

    print(f"gpu: {gpu_name_and_power()}", flush=True)
    x, W = lowdim_corpus(IVF_ROWS, IVF_DIM, dz=16, seed=21)
    q = lowdim_queries(W, IVF_BIG_BATCH)
    idx = IVFIndex(IVF_DIM, Metric.L2, IVFConfig(nlist=IVF_NLIST, nprobe=IVF_NPROBE),
                   storage_dtype=torch.bfloat16, device="cuda")
    idx.insert_batch(list(range(IVF_ROWS)), x)
    idx.optimize()
    out = ROOT / "build" / "profiles"
    out.mkdir(parents=True, exist_ok=True)
    for b, nprobe in ((SMALL_BATCH, IVF_NPROBE), (SMALL_BATCH, IVF_NPROBE_LOW),
                      (IVF_BIG_BATCH, IVF_NPROBE)):
        idx.config = dataclasses.replace(idx.config, nprobe=nprobe)
        qb = q[:b]
        for _ in range(3):
            idx.batch_search(qb, MAIN_K)
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            idx.batch_search(qb, MAIN_K)
            lat.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.batches):
                idx.batch_search(qb, MAIN_K)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.batches
        # kernels and device copies only: an operator's device time repeats
        # the time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3 / args.batches
        med = float(np.median(lat))
        print(f"\nB={b} nprobe={nprobe}: batch_search median {1e3 * med:.4g} ms "
              f"({b / med:.1f} QPS); under the profiler {1e3 * wall:.4g} ms per batch; "
              f"device busy {busy:.4g} ms per batch, idle share {1 - busy / (1e3 * med):.3f} "
              f"of the median")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3 / args.batches:9.4f} ms  "
                  f"{e.count // args.batches:3d}x  {e.key[:90]}")
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
        print("  host, self time per batch:")
        for e in host:
            print(f"  {e.self_cpu_time_total / 1e3 / args.batches:9.4f} ms  "
                  f"{e.count // args.batches:3d}x  {e.key[:90]}")
        prof.export_chrome_trace(str(out / f"ivf_trace_b{b}_np{nprobe}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
