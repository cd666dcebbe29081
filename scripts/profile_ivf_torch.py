#!/usr/bin/env python3
"""Where the time of vectorindex_tpu_torch's flat, IVF, IVF-PQ and ADC searches goes, on one GPU.

    python3 scripts/profile_ivf_torch.py [--index flat|ivf|ivfpq|adc|all] [--batches 5]

Builds the flat main path of chip_smoke.py (FlatIndex of 1,000,000 x 128
gaussian rows in bf16, L2), its IVF main path (1,000,000 x 128 lowdim
corpus, IVFIndex nlist=1024, bf16 storage, optimize()), its IVF-PQ main
path (1,000,000 x 96 lowdim corpus, IVFPQIndex pq16: nlist=4096, m=16,
ks=256, rerank_c=512, optimize()) and/or its ADC main path (bench_adc:
PQ8x8 codes of a 1,000,000 x 128 lowdim corpus, K8, exact f32 rerank).
Then, for flat B=8 and B=256, for the IVF indexes B=8 at nprobe 32 and 8
and B=256 at nprobe 32 (IVF also B=8 with k=1000, the K5 route), for ADC
B=256 ADC-only top-10 and rerank of the top 128 and 512: the median wall
time of a search over 20 calls, and a torch.profiler trace of `--batches`
calls, printed as the device time per kernel (per batch and per launch), the
device busy time per batch, the idle share (1 - busy / median wall) and the
kernel launches per batch.
Writes the chrome traces to build/profiles/. Needs a CUDA device; imports
nothing of JAX.
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
    ADC_BATCH, ADC_RERANK, IVF_BIG_BATCH, IVF_DIM, IVF_LARGE_K, IVF_NLIST, IVF_NPROBE, IVF_NPROBE_LOW,
    IVF_ROWS, MAIN_BATCH, MAIN_DIM, MAIN_K, MAIN_ROWS, PQ_BIG_BATCH, PQ_CONFIGS, PQ_DIM, PQ_NLIST,
    PQ_NPROBE, PQ_NPROBE_LOW, PQ_RERANK_C, PQ_ROWS, SMALL_BATCH, adc_build, adc_search,
    gpu_name_and_power, make_data,
)
from vectorindex_tpu_torch.bench.synth import lowdim_corpus, lowdim_queries  # noqa: E402


#: device-time groups by kernel name (first match wins)
GROUPS = (
    ("flat scan kernels (K1/K2)", ("scan_mma_kernel", "bin_candidates_kernel", "count_below_kernel")),
    ("split merge (K1/K8)", ("merge_splits",)),
    ("ADC kernels (K6-K8)", ("adc_scan_kernel", "adc_qlane_scan", "adc_candidates_kernel",
                             "adc_qlane_candidates")),
    ("probe kernels (K3-K5, K9/K10)", ("probe_scores_", "topc_", "adc_probe_")),
    ("sorts", ("Sort", "sort")),
    ("products (select, LUT, rerank)", ("gemm", "gemv", "xmma", "cutlass", "bmm")),
    ("gathers and scatters", ("index", "gather", "scatter")),
    ("copies and fills", ("Memcpy", "Memset", "fill", "copy")),
)


def build_flat():
    from vectorindex_tpu_torch.models.flat import FlatIndex
    from vectorindex_tpu_torch.utils.config import Metric

    x, q = make_data(MAIN_ROWS, MAIN_DIM, MAIN_BATCH)
    idx = FlatIndex(MAIN_DIM, Metric.L2, storage_dtype=torch.bfloat16, device="cuda")
    idx.insert_batch(list(range(MAIN_ROWS)), x)
    return [(f"B={b}", lambda: None, lambda qb=q[:b]: idx.batch_search(qb, MAIN_K))
            for b in (SMALL_BATCH, MAIN_BATCH)]


def build_ivf():
    from vectorindex_tpu_torch.models.ivf import IVFConfig, IVFIndex
    from vectorindex_tpu_torch.utils.config import Metric

    x, W = lowdim_corpus(IVF_ROWS, IVF_DIM, dz=16, seed=21)
    idx = IVFIndex(IVF_DIM, Metric.L2, IVFConfig(nlist=IVF_NLIST, nprobe=IVF_NPROBE),
                   storage_dtype=torch.bfloat16, device="cuda")
    idx.insert_batch(list(range(IVF_ROWS)), x)
    idx.optimize()
    return idx, lowdim_queries(W, IVF_BIG_BATCH), (IVF_NPROBE, IVF_NPROBE_LOW)


def build_ivfpq():
    from vectorindex_tpu_torch.models.ivf import IVFPQConfig, IVFPQIndex
    from vectorindex_tpu_torch.utils.config import Metric

    cfg = PQ_CONFIGS["pq16"]
    x, W = lowdim_corpus(PQ_ROWS, PQ_DIM, dz=16, seed=31)
    idx = IVFPQIndex(PQ_DIM, Metric.L2,
                     IVFPQConfig(nlist=PQ_NLIST, nprobe=PQ_NPROBE, m=cfg["m"], ks=cfg["ks"],
                                 rerank=True, rerank_c=PQ_RERANK_C),
                     storage_dtype=torch.float32, device="cuda")
    idx.insert_batch(list(range(PQ_ROWS)), x)
    idx.optimize()
    return idx, lowdim_queries(W, PQ_BIG_BATCH, seed=10), (PQ_NPROBE, PQ_NPROBE_LOW)


def build_adc():
    from vectorindex_tpu_torch.kernels import adc as fa

    st = adc_build()
    q = torch.from_numpy(st["queries"][ADC_BATCH : 2 * ADC_BATCH]).to("cuda")
    return [(f"B={ADC_BATCH} " + ("adc_only" if c == MAIN_K else f"rerank{c}"), lambda: None,
             lambda c=c: adc_search(fa, st, q, c)[1].cpu()) for c in (MAIN_K, *ADC_RERANK)]


def index_cases(idx, q: np.ndarray, nprobes, large_k=None):
    """(label, setup, search) for B=8 at both nprobes and B=256 at the
    first, and B=8 with k=large_k at the first if given."""
    def setup(nprobe):
        return lambda: setattr(idx, "config", dataclasses.replace(idx.config, nprobe=nprobe))

    cases = [(f"B={b} nprobe={nprobe}", setup(nprobe), lambda qb=q[:b]: idx.batch_search(qb, MAIN_K))
             for b, nprobe in ((SMALL_BATCH, nprobes[0]), (SMALL_BATCH, nprobes[1]),
                               (len(q), nprobes[0]))]
    if large_k:
        cases.append((f"B={SMALL_BATCH} nprobe={nprobes[0]} k={large_k}", setup(nprobes[0]),
                      lambda qb=q[:SMALL_BATCH]: idx.batch_search(qb, large_k)))
    return cases


def profile_searches(name: str, cases, batches: int, out: Path) -> None:
    for label, setup, run in cases:
        setup()
        for _ in range(3):
            run()
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            run()
            lat.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(batches):
                run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / batches
        # kernels and device copies only: an operator's device time repeats
        # the time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3 / batches
        launches = sum(e.count for e in events) / batches
        med = float(np.median(lat))
        b = int(label.split()[0][2:])
        print(f"\n{name} {label}: search median {1e3 * med:.4g} ms "
              f"({b / med:.1f} QPS); under the profiler {1e3 * wall:.4g} ms per batch; "
              f"device busy {busy:.4g} ms per batch, idle share {1 - busy / (1e3 * med):.3f} "
              f"of the median; {launches:.0f} kernels and copies per batch")
        print("  device ms per batch, launches per batch, device ms per launch, kernel:")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3 / batches:9.4f} ms  "
                  f"{e.count // batches:3d}x  {e.self_device_time_total / 1e3 / e.count:9.5f} ms  "
                  f"{e.key[:90]}")
        groups: dict[str, float] = {}
        for e in events:
            group = next((g for g, keys in GROUPS if any(k in e.key for k in keys)), "other")
            groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3 / batches
        print("  device time per batch by group: " + ", ".join(
            f"{g} {t:.4f} ms ({t / busy:.0%})" for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
        print("  host, self time per batch:")
        for e in host:
            print(f"  {e.self_cpu_time_total / 1e3 / batches:9.4f} ms  "
                  f"{e.count // batches:3d}x  {e.key[:90]}")
        prof.export_chrome_trace(str(out / f"{name}_trace_{label.replace(' ', '_')}.json"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", choices=("flat", "ivf", "ivfpq", "adc", "all"), default="all")
    ap.add_argument("--batches", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_ivf_torch: no CUDA device", file=sys.stderr)
        return 1
    print(f"gpu: {gpu_name_and_power()}", flush=True)
    out = ROOT / "build" / "profiles"
    out.mkdir(parents=True, exist_ok=True)
    builders = {"flat": build_flat, "ivf": lambda: index_cases(*build_ivf(), large_k=IVF_LARGE_K),
                "ivfpq": lambda: index_cases(*build_ivfpq()), "adc": build_adc}
    for name in (builders if args.index == "all" else (args.index,)):
        profile_searches(name, builders[name](), args.batches, out)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
