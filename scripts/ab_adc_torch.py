#!/usr/bin/env python3
"""A/B of the full-corpus ADC kernels K8 and K6/K7 on one GPU: queries on the lanes against rows on the lanes.

    python3 scripts/ab_adc_torch.py [--iters 20] [--section all|k8|k6k7]

Builds the port's kernels and chip_smoke.py's ADC main path (bench_adc:
PQ8x8 codes of a 1,000,000 x 128 lowdim corpus, the LUTs of 256 queries),
then on one card and in one process times, with CUDA events over `iters`
launches each, in two rounds (forward, then reversed):

  K8 (kernels/adc.adc_topk_fused): queries on the lanes, at its own query
      block (16) and grid (one wave), and at the other settings the design
      takes: query blocks 8 and 4 (more bank conflicts, more CTAs an SM)
      and twice and four times its splits;
  K8's first design (adc_topk_fused_v1): rows on the lanes, at its own grid
      (1.37 waves of resident CTAs) and at one full wave.

Before the times it prints the registers, spills and shared memory of
adc.cu's kernels (`nvcc -Xptxas -v`) and each variant's grid. After them,
from the main path's own codes, the shared-memory wavefronts one warp's
lookup instruction takes in each layout (the bank conflicts), the lookup
time they imply (lookup floor x wavefronts), and a least-squares line of
time against wavefronts over K8's query blocks, which it extends to the
first design. The card's name and power limit come first, the SM clock
under K8 (nvidia-smi) with the lookup floor after the times.

The K6/K7 section, on the main path's B=64 LUTs (K6 over the PQ8x8 codes,
K7 over the pq16x4 packed codes of the same corpus), times in two rounds
(forward, then reversed), by CUDA events over `iters` launches and by the
profiler's device time per launch:

  K6/K7 (kernels/adc.adc_scan_u8 / adc_scan_u4): queries on the lanes, at
      their own settings, and a sweep over the query block, the queries a
      lane (two, read by one 8-byte load, or one), the warp groups and
      their tile rows, and the store method (bulk copies from the
      shared-memory tile against plain stores from it);
  their first designs (adc_scan_u8_v1 / adc_scan_u4_v1): rows on the lanes;
  the write-only floor: fill_(0) of the [64, n] f32 output.

It prints the lookup floor and byte bound of each, and `-Xptxas -v` for the
K6/K7 kernels. Every variant is checked bit for bit against the plain
version first. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    ADC_BATCH, ADC_RANGE_BATCH, MAIN_K, adc_bounds, adc_build, device_ms, gpu_name_and_power,
    lookup_floor_ms, sm_clock_under, time_ms,
)

#: 256-row tiles of codes sampled for the wavefront counts
SAMPLE_TILES = 256


def kernel_label(mangled: str) -> str:
    m = re.search(r"(adc_qlane_scan_kernel)ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if m:
        qb, ksp, cnt, bits, ql = m.group(2, 3, 4, 5, 6)
        return (f"{m.group(1)}<QB={qb}, KSP={ksp}, CNT={cnt}, {'u8' if bits == '8' else 'u4'}, "
                f"QL={ql}>")
    m = re.search(r"(adc_qlane_candidates_kernel)ILi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    m = re.search(r"(adc_scan_kernel)ILb(\d)E", mangled)
    if m:
        return f"{m.group(1)}<{'packed u4' if m.group(2) == '1' else 'u8'}>"
    m = re.search(r"(adc_candidates_kernel|merge_splits_kernel)", mangled)
    return m.group(1) if m else mangled


def ptxas_report() -> None:
    """Registers, spills and static shared memory of adc.cu's kernels."""
    from vectorindex_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "adc.o"), str(_build.CSRC / "adc.cu")],
                             capture_output=True, text=True, check=True)
    name = None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif name and ("spill" in line or "Used" in line):
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)


def wavefronts(codes: np.ndarray, qb: int, ks: int) -> float:
    """Mean shared-memory wavefronts of one warp lookup instruction over
    SAMPLE_TILES tiles of codes [n, m]. qb = 1: the first design (a warp's
    lanes are 32 rows of one query, the LUT [m][ks]); qb > 1: K8 (32/qb
    rows x qb queries, the LUTs [m][ks][qb], a row's segment qb consecutive
    words). A wavefront serves one 4-byte word a bank; lanes reading one
    word share it, so the count is the most distinct words on one bank."""
    rows = 32 // qb
    tiles = np.linspace(0, codes.shape[0] // 256 - 1, SAMPLE_TILES).astype(np.int64)
    block = codes[(tiles[:, None] * 256 + np.arange(256)).ravel()].astype(np.int64)
    total = count = 0
    for j in range(codes.shape[1]):
        words = ((j * ks + block[:, j]) * qb).reshape(-1, rows)  # [warp instructions, rows]
        g = np.arange(words.shape[0])
        load = np.zeros((words.shape[0], 32), dtype=np.int64)
        for r in range(rows):
            new = (words[:, :r] != words[:, r : r + 1]).all(axis=1)  # a word not read yet
            for i in range(qb):
                np.add.at(load, (g, (words[:, r] + i) % 32), new)
        total += int(load.max(axis=1).sum())
        count += words.shape[0]
    return total / count


def k8_section(args, st, fa) -> int:
    """K8 against its first design (the section of the K8 redesign)."""
    from vectorindex_tpu_torch.kernels.scan_fused import SM_SMEM_BYTES, SMS
    from vectorindex_tpu_torch.ops import pq

    codes = st["codes"]
    lut = pq.pq_lut_l2(torch.from_numpy(st["queries"][:ADC_BATCH]).cuda(), st["books"])
    n, (b, m, ks) = codes.shape[0], lut.shape
    ntiles = -(-n // fa.C_BINS)
    print(f"shape: bench_adc's PQ{m}x{m} codes, n={n}, B={b}, m={m}, ks={ks}, k={MAIN_K}; "
          f"{b * n * m} lookups; mean of {args.iters} launches, two rounds", flush=True)

    variants = {}  # label: (layout qb for the wavefront count, launch)
    own = {}  # K8 query block: label at its own grid
    qb0 = fa.k8_query_block(m, ks)
    for qb in (qb0, qb0 // 2, qb0 // 4):
        warps, groups = fa.k8_warps(qb)
        per_sm = fa.k8_per_sm(qb, warps, m, ks)
        splits, _ = fa.k8_grid(b, qb, groups, ntiles, SMS * per_sm)
        for s in (splits, 2 * splits, 4 * splits) if qb == qb0 else (splits,):
            ctas = -(-b // qb) * groups * s
            label = f"K8 qb={qb} splits={s}"
            print(f"{label}: {warps} warps x {groups} class groups, {per_sm} CTA(s) an SM "
                  f"(occupancy query), {ctas} CTAs = {ctas / (SMS * per_sm):.3f} waves", flush=True)
            variants[label] = (qb, lambda qb=qb, s=s: fa.k8_candidates(codes, lut, qb=qb, splits=s))
        own[qb] = f"K8 qb={qb} splits={splits}"
    qb1 = fa.query_block(m, ks)
    per_sm1 = SM_SMEM_BYTES // (4 * qb1 * m * ks + 1024)  # shared memory bound
    splits1, _ = fa._grid(b, qb1, ntiles)
    for s in (splits1, (SMS * per_sm1) // -(-b // qb1)):
        ctas = -(-b // qb1) * s
        label = f"first design qb={qb1} splits={s}"
        print(f"{label}: {ctas} CTAs = {ctas / (SMS * per_sm1):.3f} waves of {SMS * per_sm1} "
              f"resident ({per_sm1} an SM by shared memory)", flush=True)
        variants[label] = (1, lambda s=s: fa.k8_v1_candidates(codes, lut, splits=s))

    ref_d, ref_i = fa.adc_topk_fused_ref(codes, lut, MAIN_K)
    for label, (_, fn) in variants.items():
        got_d, got_i = fa._select(*fn(), MAIN_K)
        if not (torch.equal(got_d, ref_d) and torch.equal(got_i, ref_i)):
            print(f"{label}: differs from the plain version", flush=True)
            return 1
    print("every variant equals the plain version bit for bit", flush=True)

    times = {label: [] for label in variants}
    for order in (list(variants), list(variants)[::-1]):
        for label in order:
            times[label].append(time_ms(variants[label][1], args.iters))
    clock = sm_clock_under(lambda: fa.k8_candidates(codes, lut))
    floor = lookup_floor_ms(b * n * m, clock)
    print(f"SM clock under K8: {clock:.0f} MHz; lookup floor (one wavefront a lookup "
          f"instruction) {floor:.4f} ms", flush=True)
    codes_np = codes.cpu().numpy()
    waves = {qb: wavefronts(codes_np, qb, ks) for qb in {qb for qb, _ in variants.values()}}
    for label, (qb, _) in variants.items():
        print(f"{label}: {np.mean(times[label]):.4f} ms (rounds {times[label][0]:.4f}, "
              f"{times[label][1]:.4f}); {waves[qb]:.3f} wavefronts a lookup instruction, "
              f"lookups alone {floor * waves[qb]:.4f} ms", flush=True)
    pts = [(waves[qb], float(np.mean(times[label]))) for qb, label in own.items()]
    slope, icept = np.polyfit([w for w, _ in pts], [t for _, t in pts], 1)
    print(f"fit over K8's query blocks at their own grids: ms = {icept:.4f} + {slope:.4f} x "
          f"wavefronts; at the first design's {waves[1]:.3f} wavefronts it gives "
          f"{icept + slope * waves[1]:.4f} ms", flush=True)
    k8_dev = [device_ms(lambda: fa.k8_candidates(codes, lut), 10, "adc_qlane_candidates")
              for _ in range(2)]
    print(f"K8 device time per launch at its own settings (profiler): rounds {k8_dev[0]:.4f}, "
          f"{k8_dev[1]:.4f} ms", flush=True)
    return 0


def k6k7_section(args, st, fa) -> int:
    """K6/K7 at B=64 against their first designs, a sweep of the design's
    settings, the write-only floor and each kernel's bounds."""
    from vectorindex_tpu_torch.ops import pq

    q64 = torch.from_numpy(st["queries"][:ADC_RANGE_BATCH]).cuda()
    cases = {"K6": (st["codes"], pq.pq_lut_l2(q64, st["books"]), False),
             "K7": (st["packed"], pq.pq_lut_l2(q64, st["books4"]), True)}
    variants = {}  # label: (kernel name filter for the profiler, launch)
    for name, (codes, lut, packed) in cases.items():
        b, m, ks = lut.shape
        qb0 = fa.scan_query_block(m, ks)
        new = fa.adc_scan_u4 if packed else fa.adc_scan_u8
        old = fa.adc_scan_u4_v1 if packed else fa.adc_scan_u8_v1
        ql0 = fa.scan_lane_queries(qb0)
        variants[f"{name} own (qb={qb0}, {ql0} queries a lane, {fa.SCAN_GROUPS} groups x "
                 f"{fa.scan_tile_rows(qb0)} rows, bulk)"] = (
            "adc_qlane_scan", lambda c=codes, lt=lut, f=new: f(c, lt))
        variants[f"{name} first design"] = ("adc_scan_kernel", lambda c=codes, lt=lut, f=old: f(c, lt))
        for qb in (qb0, qb0 // 2):
            for ql in (2, 1):
                for groups in (1, 2, 4, 16):
                    for rows in (32, 64, 128, 256, 512):
                        for bulk in (True, False):
                            if (rows % fa.scan_pass_rows(qb, groups, ql) or rows % 32
                                    or fa.scan_smem(qb, m, ks, rows, groups, ql) > fa.MAX_SMEM_BYTES
                                    or (not bulk and (groups, ql) != (16, 2))
                                    or groups * rows < 256 or (ql == 1 and qb != qb0)):
                                continue
                            store = "bulk" if bulk else "plain"
                            variants[f"{name} qb={qb} ql={ql} {groups} groups x {rows} rows "
                                     f"{store}"] = ("adc_qlane_scan", lambda c=codes, lt=lut, kw=dict(
                                         qb=qb, ql=ql, groups=groups, tile_rows=rows, bulk=bulk),
                                         p=packed: fa.scan_launch(c, lt, p, **kw))
    refs = {name: (pq.unpack_u4(c) if p else c, lt) for name, (c, lt, p) in cases.items()}
    for label, (_, fn) in variants.items():
        codes, lut = refs[label[:2]]
        if not torch.equal(fn(), fa.adc_scan_u8_ref(codes, lut)):
            print(f"{label}: differs from the plain version", flush=True)
            return 1
    print(f"K6/K7: every one of {len(variants)} variants equals the plain version bit for bit",
          flush=True)
    times = {label: [] for label in variants}
    dev = {label: [] for label in variants}
    for order in (list(variants), list(variants)[::-1]):
        for label in order:
            match, fn = variants[label]
            times[label].append(time_ms(fn, args.iters))
            dev[label].append(device_ms(fn, 5, match))
    out = torch.empty(cases["K6"][1].shape[0], st["codes"].shape[0], device="cuda")
    fill = [device_ms(lambda: out.fill_(0), 10) for _ in range(2)]
    del out
    clock = sm_clock_under(lambda: fa.adc_scan_u8(*cases["K6"][:2]))
    print(f"write-only floor (fill_ of the [64, n] f32 output, profiler): rounds {fill[0]:.4f}, "
          f"{fill[1]:.4f} ms; SM clock under K6 {clock:.0f} MHz", flush=True)
    for name, (codes, lut, packed) in cases.items():
        b, m, ks = lut.shape
        bnd = adc_bounds(codes.shape[0], b, m, ks, codes.shape[1])
        print(f"{name}: B={b}, n={codes.shape[0]}, m={m}, ks={ks}; byte bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), half of it {bnd[0] / 2:.4f} ms; lookup floor "
              f"{lookup_floor_ms(b * codes.shape[0] * m, clock):.4f} ms", flush=True)
    for label in variants:
        print(f"{label}: events {np.mean(times[label]):.4f} ms (rounds {times[label][0]:.4f}, "
              f"{times[label][1]:.4f}); device {np.mean(dev[label]):.4f} ms (rounds "
              f"{dev[label][0]:.4f}, {dev[label][1]:.4f})", flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--section", choices=("all", "k8", "k6k7"), default="all")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_adc_torch: no CUDA device", file=sys.stderr)
        return 1
    from vectorindex_tpu_torch.kernels import _build
    from vectorindex_tpu_torch.kernels import adc as fa

    print(f"gpu: {gpu_name_and_power()}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas_report()
    st = adc_build()
    if args.section in ("all", "k8") and k8_section(args, st, fa):
        return 1
    if args.section in ("all", "k6k7") and k6k7_section(args, st, fa):
        return 1
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
