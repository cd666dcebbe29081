#!/usr/bin/env python3
"""Sweep of the flat scan's FMA design (K1/K2 on the CUDA cores) on one GPU.

    python3 scripts/ab_scan_fma_torch.py [--shapes all|NAME,...] [--iters 10] [--quick]
                                         [--out build/ab_scan_fma.json]

Builds the port's kernels, prints `nvcc -Xptxas -v`'s registers and spills
of every FMA-design kernel (and the CUDA runtime's own count), then at each
shape (L2, k=10; seeded torch data made on the card):

  f32_128_b256   2^20 x 128 f32 (1,000,000 live rows), B=256: the bench
                 CLI's flat index
  f32_128_b8     the same rows, B=8
  bf16_3072_b64  2^17 x 3,072 bf16 (120,000 live rows), B=64: the wide
                 flat index of chip_smoke.py's phase_flat_wide
  f32_768_b256   2^20 x 768 f32 (3.2 GB), B=256: an embedding width
                 (BERT-base, all-mpnet-base-v2)
  f32_768_b8     the same rows, B=8

it times K1 and K2 under fma_plan's default plan and under each variant of
query block (qb), micro-tile (tm), ring stages, k chunk (kc) and splits,
in turns with the first design (`_v1`): CUDA events over `iters` launches
and the profiler's device time per launch. Every
variant is first checked bit for bit against the first design. --quick
times the default plans only. The card's name and power limit come first
(nvidia-smi); a JSON summary goes to --out. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED, K = 1234, 10
SHAPES = {
    "f32_128_b256": (1 << 20, 1_000_000, 128, torch.float32, 256),
    "f32_128_b8": (1 << 20, 1_000_000, 128, torch.float32, 8),
    "bf16_3072_b64": (1 << 17, 120_000, 3072, torch.bfloat16, 64),
    "f32_768_b256": (1 << 20, 1 << 20, 768, torch.float32, 256),
    "f32_768_b8": (1 << 20, 1 << 20, 768, torch.float32, 8),
}
HBM_BYTES_S, F32_FLOPS = 3.35e12, 67e12
KERNEL_RE = re.compile(r"scan_fma_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)ELi(\d)ELi(\d)E")
METRICS = {"0": "L2", "1": "IP", "2": "cos"}


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, calls: int) -> float:
    """The profiler's device time per call of fn() (every kernel it launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / calls


def ptxas_report() -> list:
    """Registers and spills of scan_fused.cu's FMA-design kernels from
    `nvcc -Xptxas -v`."""
    from vectorindex_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "scan_fused.o"), str(_build.CSRC / "scan_fused.cu")],
                             capture_output=True, text=True, check=True)
    rows, name = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = KERNEL_RE.search(m.group(1))
            name = None if k is None else (
                f"scan_fma_kernel<{'f32' if k.group(1) == 'f' else 'bf16'},{METRICS[k.group(2)]},"
                f"{'top3' if k.group(3) == '0' else 'count'},{k.group(4)}x{k.group(5)}>")
        elif name and ("spill" in line or "Used" in line):
            rows.append((name, line.split(":", 1)[-1].strip()))
            print(f"ptxas {name}: {rows[-1][1]}", flush=True)
    return rows


def make_shape(name: str):
    """(qk, x, bias, tau source) of one shape: gaussian rows on the card,
    dead slots past the live rows, queries near some rows."""
    from vectorindex_tpu_torch.kernels import scan_fused as sf
    from vectorindex_tpu_torch.utils.config import Metric

    n, live, d, dtype, b = SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(SEED + d)
    x = torch.zeros(n, d, dtype=dtype, device="cuda")
    for s in range(0, live, 1 << 18):  # in slices: no f32 copy of a bf16 corpus
        e = min(s + (1 << 18), live)
        x[s:e] = torch.randn(e - s, d, generator=gen, device="cuda").to(dtype)
    valid = torch.arange(n, device="cuda") < live
    sq = torch.empty(n, device="cuda")
    for s in range(0, n, 1 << 18):
        xf = x[s : s + (1 << 18)].float()
        sq[s : s + (1 << 18)] = (xf * xf).sum(dim=1)
    pick = torch.randint(0, live, (b,), generator=gen, device="cuda")
    q = x[pick].float() + 0.1 * torch.randn(b, d, generator=gen, device="cuda")
    qk, bias, cs, _ = sf.kernel_inputs(q, sq, valid, Metric.L2)
    return qk, x, bias


def bound_ms(n: int, d: int, b: int, itemsize: int) -> tuple:
    nbytes = n * (d * itemsize + 4) + b * d * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_S, 2.0 * b * n * d / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def variants(sf, kernel: str, b: int, n: int, d: int, dtype, quick: bool) -> list:
    """Plans to time: the default, then one choice changed at a time."""
    base = sf.fma_plan(b, n, d, dtype, kernel)
    out = [("default", base)]
    if quick:
        return out
    tries = []
    for tm in (4, 8):
        for qb in sf.FMA_QUERY_BLOCKS[tm]:
            if (tm, qb) != (base.tm, base.qb) and qb <= max(64, 2 * b):
                tries.append((f"tm={tm} qb={qb}", dict(tm=tm, qb=qb)))
    for st in (2, 3, 4):
        if st != base.stages:
            tries.append((f"stages={st}", dict(stages=st, kc=base.kc)))
    for kc in (32, 64, 128, 256):
        if kc != base.kc and kc < d:
            tries.append((f"kc={kc}", dict(kc=kc)))
    for mult in (2, 4):
        tries.append((f"splits x{mult}", dict(splits=base.splits * mult)))
    for label, kw in tries:
        kw.setdefault("tm", base.tm)
        try:
            out.append((label, sf.fma_plan(b, n, d, dtype, kernel, **kw)))
        except ValueError as e:
            print(f"  ({kernel} {label}: {e})", flush=True)
    return out


def sweep_shape(sf, name: str, iters: int, quick: bool) -> dict:
    from vectorindex_tpu_torch.ops.topk import topk
    from vectorindex_tpu_torch.utils.config import Metric

    n, _, d, dtype, b = SHAPES[name]
    t0 = time.perf_counter()
    qk, x, bias = make_shape(name)
    L2 = Metric.L2
    vd, vi = sf.bin_candidates_fma_v1(qk, x, bias, None, metric=L2)
    sd, _ = topk(vd.view(b, -1), K, ids=vi.view(b, -1), strict_ties=True)
    tau = sd[:, K - 1].contiguous()
    vlt, vle = sf.count_below_fma_v1(qk, x, bias, None, tau, metric=L2)
    torch.cuda.synchronize()
    bms, by = bound_ms(n, d, b, x.element_size())
    print(f"{name}: n={n} d={d} {str(dtype).split('.')[-1]} B={b}, data in "
          f"{time.perf_counter() - t0:.1f} s; bound {bms:.4g} ms ({by})", flush=True)
    res = {"bound_ms": bms, "bound_by": by, "kernels": {}}
    calls = {
        "bin_candidates": (lambda p: (lambda: sf._fma_candidates("bin_candidates_fma", qk, x, bias,
                                                                 None, L2, p)),
                           lambda: sf.bin_candidates_fma_v1(qk, x, bias, None, metric=L2)),
        "count_below": (lambda p: (lambda: sf._launch_counts("count_below", qk, x, bias, None, tau,
                                                             L2, "fma", p)),
                        lambda: sf.count_below_fma_v1(qk, x, bias, None, tau, metric=L2)),
    }
    want = {"bin_candidates": (vd, vi), "count_below": (vlt, vle)}
    few = max(2, iters // 4) if d > 256 else iters
    for kernel, (make, v1) in calls.items():
        rows = []
        v1_ms = [time_ms(v1, few)]
        for label, p in variants(sf, kernel, b, n, d, dtype, quick):
            fn = make(p)
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, w) for a, w in zip(got, want[kernel]))
            if not same:
                raise AssertionError(f"{name} {kernel} {label}: differs from the first design")
            ms = time_ms(fn, iters)
            dev = device_ms(fn, max(3, iters // 2))
            rows.append({"variant": label, "plan": p._asdict(), "ms": ms, "device_ms": dev})
            print(f"  {kernel} {label:14s} {p}: {ms:.4g} ms, device {dev:.4g} ms (bit for bit "
                  "with the first design)", flush=True)
        v1_ms.append(time_ms(v1, few))
        v1_dev = device_ms(v1, 3)
        best = min(rows, key=lambda r: r["device_ms"])
        print(f"  {kernel} first design {v1_ms[0]:.4g} / {v1_ms[1]:.4g} ms (before / after), "
              f"device {v1_dev:.4g} ms; best {best['variant']} {best['device_ms']:.4g} ms device, "
              f"{bms / best['device_ms']:.1%} of the bound", flush=True)
        res["kernels"][kernel] = {"variants": rows, "first_design_ms": v1_ms,
                                  "first_design_device_ms": v1_dev}
    del qk, x, bias, vd, vi
    torch.cuda.empty_cache()
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", default="all")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--out", default=str(ROOT / "build" / "ab_scan_fma.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_scan_fma_torch: no CUDA device", file=sys.stderr)
        return 1
    from vectorindex_tpu_torch.kernels import _build
    from vectorindex_tpu_torch.kernels import scan_fused as sf

    gpu = gpu_name_and_power()
    print(f"gpu: {gpu}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    ptx = ptxas_report()
    attrs = sf.fma_attributes()
    for key, (regs, local) in sorted(attrs.items()):
        print(f"runtime {key}: {regs} registers, {local} local bytes", flush=True)
    names = list(SHAPES) if args.shapes == "all" else args.shapes.split(",")
    out = {"gpu": gpu, "ptxas": ptx, "attributes": {str(k): v for k, v in attrs.items()},
           "shapes": {}}
    for name in names:
        out["shapes"][name] = sweep_shape(sf, name, args.iters, args.quick)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
