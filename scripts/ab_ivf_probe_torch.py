#!/usr/bin/env python3
"""A/B of the IVF-Flat probe kernels K3, K4 and K5 on one GPU: the list-major and one-launch designs against the first ones.

    python3 scripts/ab_ivf_probe_torch.py [--iters 30] [--profiled 10]

Builds the port's kernels and chip_smoke.py's IVF main path (IVFIndex
nlist=1024, bf16 storage, 1,000,000 x 128 lowdim rows, optimize()), takes the
probe tables of 256 queries and of 8 (nprobe=32), and prints, in one process
on one card:

  - the card's name and power limit, and `nvcc -Xptxas -v`'s registers,
    spills and shared memory for each kernel of csrc/ivf_probe.cu;
  - at B=256 the distribution of queries per probed list and the groups
    that kernels/ivf_probe.probe_groups makes of them;
  - the bytes each design reads, from the code's own count (this script
    does not run ncu): every live row a CTA stages or loads (d * itemsize
    + 4 bytes for ||x||^2), the outputs written once, K3's partials
    written and read, beside the bound's bytes (each distinct row once);
  - torch.profiler device times per call of each of those variants: the
    probe kernels apart from the wrapper's other device work (K4's
    grouping: sort, searchsorted; the query terms);
  - CUDA-event times, two rounds in turns (forward, then reversed), of
    each design, of the new kernels at other chunk sizes (K4 and K3 rows
    per CTA) and of K5 with the grouping serving batches skip, each first
    checked bit for bit against the plain version.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    IVF_BIG_BATCH, IVF_DIM, IVF_NLIST, IVF_NPROBE, IVF_ROWS, SMALL_BATCH, gpu_name_and_power,
    lowdim_corpus, lowdim_queries, probe_tables, time_ms,
)

#: kernels of csrc/ivf_probe.cu by their names in ptxas and profiler output
KERNELS = ("probe_scores_grouped_kernel", "probe_scores_kernel", "topc_kernel",
           "topc_scan_kernel", "topc_merge_kernel")


def kernel_label(name: str) -> str:
    for k in KERNELS:
        if re.search(rf"(^|[^a-z_]){k}", name) or f"{len(k)}{k}" in name:
            return k
    return name[:60]


def ptxas_report() -> None:
    """Registers, spills and static shared memory of ivf_probe.cu's
    kernels, one line per distinct report."""
    from vectorindex_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "ivf_probe.o"), str(_build.CSRC / "ivf_probe.cu")],
                             capture_output=True, text=True, check=True)
    seen, name = defaultdict(set), None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif name and ("spill" in line or "Used" in line):
            seen[name].add(line.split(":", 1)[-1].strip())
    for name, lines in seen.items():
        for line in sorted(lines):
            print(f"ptxas {name}: {line}", flush=True)


def build_ivf():
    from vectorindex_tpu_torch.models.ivf import IVFConfig, IVFIndex
    from vectorindex_tpu_torch.ops import ivf as tivf
    from vectorindex_tpu_torch.utils.config import Metric

    x, W = lowdim_corpus(IVF_ROWS, IVF_DIM, dz=16, seed=21)
    idx = IVFIndex(IVF_DIM, Metric.L2, IVFConfig(nlist=IVF_NLIST, nprobe=IVF_NPROBE),
                   storage_dtype=torch.bfloat16, device="cuda")
    idx.insert_batch(list(range(IVF_ROWS)), x)
    idx.optimize()
    q = lowdim_queries(W, IVF_BIG_BATCH)
    idx.batch_search(q[:SMALL_BATCH], 10)  # packs the lists
    arrays = idx._store.sync_device(idx.storage_dtype)
    cap = tivf.probe_cap_for(idx._store.max_length)
    tables = {}
    for b in (IVF_BIG_BATCH, SMALL_BATCH):
        qb = torch.from_numpy(q[:b]).cuda()
        tables[b] = (qb, *probe_tables(qb, idx._centroids_dev, arrays, IVF_NPROBE, idx.metric),
                     arrays.vecs, arrays.sqnorms)
    return tables, cap, idx.metric


def group_stats(kp, starts, lives) -> None:
    """Queries per probed list and the groups of probe_groups at B=256."""
    flat = starts.flatten()
    _, counts = torch.unique(flat, return_counts=True)
    c = counts.cpu().numpy()
    _, glen = kp.probe_groups(starts)
    g = glen[glen > 0].cpu().numpy()
    print(f"B={starts.shape[0]} nprobe={starts.shape[1]}: {flat.numel()} pairs on {len(c)} "
          f"distinct lists; queries per probed list min {c.min()}, median {np.median(c):.0f}, "
          f"mean {c.mean():.2f}, p90 {np.percentile(c, 90):.0f}, p99 {np.percentile(c, 99):.0f}, "
          f"max {c.max()}; lists probed once {(c == 1).sum()}, by >16 queries {(c > 16).sum()}",
          flush=True)
    print(f"probe_groups (at most {kp.PROBE_GROUP} pairs): {len(g)} groups, pairs a group mean "
          f"{g.mean():.2f}, median {np.median(g):.0f}; histogram of queries per list "
          f"{np.bincount(np.minimum(c, 32))[1:].tolist()} (1..31, >=32)", flush=True)


def bytes_read(kp, args, cap: int) -> dict:
    """Bytes each design moves, counted from the code: rows staged or
    loaded (d * itemsize + 4 each), outputs written once, K3's partials
    written and read once; 'bound' counts each distinct row once."""
    q, starts, lives, vecs, _ = args
    b, nprobe = starts.shape
    row = q.shape[1] * vecs.element_size() + 4
    lv = lives.flatten().long()
    fs = starts.flatten().long()
    order, glen = kp.probe_groups(starts)
    lead = torch.nonzero(glen).flatten()
    srt_live = lv[order.long()]
    group_max = torch.stack([srt_live[p : p + int(n)].max() for p, n in
                             zip(lead.tolist(), glen[lead].tolist())]) if len(lead) else lv[:0]
    _, first = np.unique(fs.cpu().numpy(), return_index=True)
    scores_out = b * nprobe * cap * 4
    k3_out = b * kp.TIERS * kp.CBINS * 8 + b * kp.CBINS * 4
    part = (kp.TIERS + 1) * kp.CBINS * 8

    def live_chunks(chunk):
        return int(((lv + chunk - 1) // chunk).sum())

    return {
        "bound rows": int(lv[torch.from_numpy(first).to(lv.device)].sum()) * row,
        "K4/K5 first design rows": int(lv.sum()) * row,
        "K4/K5 list-major rows": int(group_max.sum()) * row,
        "K4/K5 output": scores_out,
        "K3 rows (both designs)": int(lv.sum()) * row,
        "K3 first design partials": 2 * part * live_chunks(kp._topc_chunk_rows_v1(cap)),
        "K3 one-launch partials": 2 * part * live_chunks(kp._topc_chunk_rows(cap, b * nprobe)),
        "K3 output": k3_out,
    }


def device_times(calls: dict, n: int) -> dict:
    """torch.profiler device time per call by kernel, for each design."""
    out = {}
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        per = defaultdict(float)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                per[kernel_label(e.key)] += e.self_device_time_total / 1e3 / n
        out[label] = dict(per)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--profiled", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_ivf_probe_torch: no CUDA device", file=sys.stderr)
        return 1
    from vectorindex_tpu_torch.kernels import _build
    from vectorindex_tpu_torch.kernels import ivf_probe as kp

    print(f"gpu: {gpu_name_and_power()}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas_report()
    t0 = time.perf_counter()
    tables, cap, metric = build_ivf()
    print(f"ivf main path built in {time.perf_counter() - t0:.1f} s: nlist={IVF_NLIST}, "
          f"nprobe={IVF_NPROBE}, probe_cap={cap}", flush=True)
    a256, a8 = tables[IVF_BIG_BATCH], tables[SMALL_BATCH]
    kw = dict(nprobe=IVF_NPROBE, probe_cap=cap, metric=metric)
    group_stats(kp, a256[1], a256[2])
    for b, a in ((IVF_BIG_BATCH, a256), (SMALL_BATCH, a8)):
        for name, nbytes in bytes_read(kp, a, cap).items():
            print(f"bytes B={b} {name}: {nbytes} ({nbytes / 3.35e9:.4f} ms at 3.35 TB/s)",
                  flush=True)

    variants = {  # label: (call, plain version, args)
        "K4 list-major B=256": (lambda: kp.ivf_probe_scores(*a256, **kw), kp.ivf_probe_scores_ref, a256),
        "K4 first design B=256": (lambda: kp.ivf_probe_scores_v1(*a256, **kw), kp.ivf_probe_scores_ref, a256),
        "K5 list-major B=8": (lambda: kp.ivf_probe_scores_rankmajor(*a8, **kw),
                              kp.ivf_probe_scores_rankmajor_ref, a8),
        "K5 first design B=8": (lambda: kp.ivf_probe_scores_v1(*a8, deny_sentinel=True, **kw),
                                kp.ivf_probe_scores_rankmajor_ref, a8),
        "K3 one launch B=8": (lambda: kp.ivf_probe_topc_rankmajor(*a8, **kw),
                              kp.ivf_probe_topc_rankmajor_ref, a8),
        "K3 first design B=8": (lambda: kp.ivf_probe_topc_v1(*a8, **kw),
                                kp.ivf_probe_topc_rankmajor_ref, a8),
    }
    for chunk in (512, 1024, 2048):
        variants[f"K4 list-major B=256 chunk {chunk}"] = (
            lambda c=chunk: kp._launch_scores(*a256, cap, metric, False, chunk_rows=c),
            kp.ivf_probe_scores_ref, a256)
    variants["K5 list-major B=8 grouped"] = (
        lambda: kp._launch_scores(*a8, cap, metric, True, grouped=True),
        kp.ivf_probe_scores_rankmajor_ref, a8)
    for chunk in (256, 512, 1024, 2048):
        variants[f"K3 one launch B=8 chunk {chunk}"] = (
            lambda c=chunk: kp._launch_topc(*a8, IVF_NPROBE, cap, metric, chunk_rows=c),
            kp.ivf_probe_topc_rankmajor_ref, a8)
    for label, (fn, ref, a) in variants.items():
        got, want = fn(), ref(*a, **kw)
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        if not all(torch.equal(x, y) for x, y in pairs):
            print(f"{label}: differs from the plain version", flush=True)
            return 1
    print("every variant equals its plain version bit for bit", flush=True)

    for label, per in device_times({k: v[0] for k, v in variants.items()}, args.profiled).items():
        ours = sum(v for k, v in per.items() if k in KERNELS)
        rest = sum(v for k, v in per.items() if k not in KERNELS)
        parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1])
                          if k in KERNELS)
        print(f"profiler {label}: probe kernels {ours:.4f} ms a call ({parts}); other device "
              f"work of the wrapper {rest:.4f} ms", flush=True)

    times = {label: [] for label in variants}
    for order in (list(times), list(times)[::-1]):
        for label in order:
            times[label].append(time_ms(variants[label][0], args.iters))
    for label, r in times.items():
        print(f"events {label}: {np.mean(r):.4f} ms (rounds {r[0]:.4f}, {r[1]:.4f})", flush=True)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
