#!/usr/bin/env python3
"""A/B of the full-corpus ADC kernels K8 and K6/K7 on one GPU: each against its earlier designs and over its own settings.

    python3 scripts/ab_adc_torch.py [--iters 20] [--section all|k8|k6k7]

Builds the port's kernels and chip_smoke.py's ADC main path (bench_adc:
PQ8x8 codes of a 1,000,000 x 128 lowdim corpus, the LUTs of 256 queries),
prints `nvcc -Xptxas -v` for adc.cu's and adc_topk.cu's kernels (registers,
spills, shared memory), then on one card and in one process:

The K8 section, at B=256, times by CUDA events over `iters` launches (two
rounds: forward, then reversed) and by the profiler's device time a launch:

  K8 (kernels/adc.k8_candidates, csrc/adc_topk.cu) under k8_plan and k8_ctas,
      and at each variant its kernel table holds: four, two or one queries a
      lane, skew on or off, 2, 3 or 4 code-ring stages, and grids of the
      resident CTAs (every SM, CTAs crossing streams), twice them and half;
  its second design (k8_v2_candidates: queries on the lanes, one a lane,
      codes by the threads' own loads) and its first (k8_v1_candidates: rows
      on the lanes), each at its own grid;
  then, at other shapes (PQ8x8, pq16x4, pq32x4, PQ16, m = 7, 9, 32, 64 and
      96 at B = 256, 64, 8 and 1 over the main path's row count of random
      codes; m = 96 is one k8_route sends to the second design), K8's kernel
      against its second design by the profiler's device time, each first
      checked bit for bit.

Every variant is first checked bit for bit against the plain version's
candidates. After the times it prints the SM clock under K8 (nvidia-smi),
the lookup floor (one wavefront a lookup instruction) and, from the main
path's own codes, the shared-memory wavefronts one warp's lookup
instruction takes in each layout: a wavefront serves 128 bytes, a warp's
loads of 4, 8 or 16 bytes a lane are served 32, 16 or 8 lanes at a time,
and within those the count is the most distinct 4-byte words on one bank.
K8's skewed layout takes 1 a served group whatever the codes; the unskewed
layouts take more where two row slots' segments meet on the same banks.

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

It prints the lookup floor and byte bound of each. Every variant is checked
bit for bit against the plain version first. Imports nothing of JAX.
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
from vectorindex_tpu_torch.kernels.adc import k8_ks_pad  # noqa: E402

#: 256-row tiles of codes sampled for the wavefront counts
SAMPLE_TILES = 256


def kernel_label(mangled: str) -> str:
    m = re.search(r"(adc_qlane_scan_kernel)ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if m:
        qb, ksp, cnt, bits, ql = m.group(2, 3, 4, 5, 6)
        return (f"{m.group(1)}<QB={qb}, KSP={ksp}, CNT={cnt}, {'u8' if bits == '8' else 'u4'}, "
                f"QL={ql}>")
    m = re.search(r"(adc_ring_candidates_kernel)ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if m:
        qb, ksp, ql, skew, cnt = m.group(2, 3, 4, 5, 6)
        return f"{m.group(1)}<QB={qb}, KSP={ksp}, QL={ql}, S={skew}, CNT={cnt}>"
    m = re.search(r"(adc_qlane_candidates_kernel)ILi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    m = re.search(r"(adc_scan_kernel)ILb(\d)E", mangled)
    if m:
        return f"{m.group(1)}<{'packed u4' if m.group(2) == '1' else 'u8'}>"
    m = re.search(r"(adc_candidates_kernel|merge_splits_kernel|merge_segments_kernel)", mangled)
    return m.group(1) if m else mangled


def ptxas_report() -> None:
    """Registers, spills and static shared memory of adc.cu's and
    adc_topk.cu's kernels."""
    from vectorindex_tpu_torch.kernels import _build

    for src in ("adc.cu", "adc_topk.cu"):
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                                  str(Path(tmp) / "k.o"), str(_build.CSRC / src)],
                                 capture_output=True, text=True, check=True)
        name = None
        for line in (out.stdout + out.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = kernel_label(m.group(1))
            elif name and ("spill" in line or "Used" in line):
                print(f"ptxas {src} {name}: {line.split(':', 1)[-1].strip()}", flush=True)


def wavefronts(codes: np.ndarray, qb: int, ql: int, skew: int, ks: int) -> float:
    """Mean shared-memory wavefronts of one warp's lookup instruction over
    SAMPLE_TILES tiles of codes [n, m], in the layout of lut_blocks(lut, qb,
    ql, skew): a warp holds 32·ql/qb row slots of qb/ql lanes, lane q of a
    slot of skew s reads, for subspace i of sub-block h = (f - s) mod skew
    in phase f, the 4·ql bytes at i·KSP·line + code·line + h·qb·4 + 4·ql·q
    (line = skew·qb·4). (qb, ql, skew) = (1, 1, 1) is the first design
    (rows on the lanes, [m][ks]); (16, 1, 1) the second (queries on the
    lanes, one a lane). A warp's loads are served 128 / (4·ql) lanes at a
    time; each served group takes as many wavefronts as the most distinct
    4-byte words on one bank; lanes reading one word share it."""
    kpad = k8_ks_pad(ks)
    lanes, slots = qb // ql, 32 * ql // qb
    line, served = skew * qb * 4, 32 // ql
    m = codes.shape[1]
    mb = -(-m // skew)
    tiles = np.linspace(0, codes.shape[0] // 256 - 1, SAMPLE_TILES).astype(np.int64)
    lane = np.arange(32)
    q, slot = lane % lanes, lane // lanes
    s = slot % skew
    total = count = 0
    for t in tiles:
        for p0 in range(0, 256 // slots, 4):  # a few row slots' rows of the tile
            for f in range(skew):
                h = (f - s) % skew
                for i in range(mb):
                    j = h * mb + i
                    rows = t * 256 + p0 * slots + slot - (skew > 1) * (f < s) * 256
                    stored = codes[np.clip(rows, 0, None), np.minimum(j, m - 1)]
                    code = np.where((j < m) & (rows >= 0), stored, 0)
                    byte = i * kpad * line + code.astype(np.int64) * line + h * qb * 4 + 4 * ql * q
                    words = byte[:, None] // 4 + np.arange(ql)[None, :]  # [lane, word]
                    for g in range(0, 32, served):
                        w = np.unique(words[g : g + served].ravel())
                        total += int(np.bincount(w % 32, minlength=32).max())
                    count += 1
    return total / count


def k8_section(args, st, fa) -> int:
    """K8 under its plan and the variants its kernel table holds, against
    its second and first designs (the section of the K8 redesigns)."""
    from vectorindex_tpu_torch.kernels.scan_fused import SMS
    from vectorindex_tpu_torch.ops import pq

    codes = st["codes"]
    lut = pq.pq_lut_l2(torch.from_numpy(st["queries"][:ADC_BATCH]).cuda(), st["books"])
    n, (b, m, ks) = codes.shape[0], lut.shape
    print(f"shape: bench_adc's PQ{m}x{m} codes, n={n}, B={b}, m={m}, ks={ks}, k={MAIN_K}; "
          f"{b * n * m} lookups; mean of {args.iters} launches, two rounds", flush=True)
    table = fa.k8_ring_attributes()
    plan0 = fa.k8_plan(m, ks, b)
    resident = SMS * fa.k8_ring_per_sm(plan0, m, ks)
    own = fa.k8_ctas(plan0, b, n, resident)
    variants = {}  # label: (layout (qb, ql, skew) for the wavefront count, kernel filter, launch)
    plans = {plan0: "own plan"}
    for ql in (4, 2, 1):
        for skew in (None, 1):
            plans.setdefault(fa.k8_plan(m, ks, b, ql=ql, skew=skew), f"ql={ql} skew={skew or 'on'}")
    for stages in (2, 3):
        plans.setdefault(fa.k8_plan(m, ks, b, stages=stages), f"stages={stages}")
    for plan, why in plans.items():
        if (plan.qb, k8_ks_pad(ks), plan.ql, plan.skew, fa.k8_cnt(m, plan.skew)) not in table:
            print(f"K8 {why} {plan}: not in adc_topk.cu's kernel table, skipped", flush=True)
            continue
        ctas = fa.k8_ctas(plan, b, n, SMS * fa.k8_ring_per_sm(plan, m, ks))
        label = f"K8 {why}: {plan}, {ctas} CTAs"
        variants[label] = ((plan.qb, plan.ql, plan.skew), "adc_ring",
                           lambda p=plan, c=ctas: fa.k8_candidates(codes, lut, plan=p, ctas=c))
    for ctas in (resident, 2 * resident, resident // 2):
        if ctas != own:
            variants[f"K8 own plan, {ctas} CTAs"] = (
                (plan0.qb, plan0.ql, plan0.skew), "adc_ring",
                lambda c=ctas: fa.k8_candidates(codes, lut, ctas=c))
    qb2 = fa.k8_query_block(m, ks)
    variants[f"second design qb={qb2}, own grid"] = (
        (qb2, 1, 1), "adc_qlane_candidates", lambda: fa.k8_v2_candidates(codes, lut))
    variants["first design (rows on the lanes), own grid"] = (
        (1, 1, 1), "adc_candidates_kernel", lambda: fa.k8_v1_candidates(codes, lut))

    ref_d, ref_i = fa.adc_topk_candidates_ref(codes, lut)
    for label, (_, _, fn) in variants.items():
        got_d, got_i = fn()
        if not (torch.equal(got_d, ref_d) and torch.equal(got_i, ref_i)):
            print(f"{label}: differs from the plain version", flush=True)
            return 1
    print(f"every one of {len(variants)} variants equals the plain version bit for bit", flush=True)

    times = {label: [] for label in variants}
    dev = {label: [] for label in variants}
    for order in (list(variants), list(variants)[::-1]):
        for label in order:
            _, match, fn = variants[label]
            times[label].append(time_ms(fn, args.iters))
            dev[label].append(device_ms(fn, 5, match))
    clock = sm_clock_under(lambda: fa.k8_candidates(codes, lut))
    floor = lookup_floor_ms(b * n * m, clock)
    print(f"SM clock under K8: {clock:.0f} MHz; lookup floor (one wavefront a lookup "
          f"instruction) {floor:.4f} ms; bound {adc_bounds(n, b, m, ks, m, MAIN_K)[0]:.4f} ms "
          f"(operations)", flush=True)
    codes_np = codes.cpu().numpy()
    waves = {lay: wavefronts(codes_np, *lay, ks) for lay in {v[0] for v in variants.values()}}
    for lay, w in sorted(waves.items()):
        print(f"layout qb={lay[0]} ql={lay[1]} skew={lay[2]}: {w:.3f} wavefronts a lookup "
              f"instruction ({w / (4 * lay[1] * 32 / 128):.3f} of its least)", flush=True)
    for label, (lay, _, _) in variants.items():
        print(f"{label}: events {np.mean(times[label]):.4f} ms (rounds {times[label][0]:.4f}, "
              f"{times[label][1]:.4f}); device {np.mean(dev[label]):.4f} ms (rounds "
              f"{dev[label][0]:.4f}, {dev[label][1]:.4f}); {np.mean(dev[label]) / floor:.2f}x the "
              f"lookup floor", flush=True)
    return other_shapes(fa, n)


#: K8's other shapes: (m, ks) of random codes, timed at these batches
OTHER_SHAPES = ((8, 256), (16, 16), (32, 16), (16, 256), (7, 200), (9, 256), (32, 256), (64, 256),
                (96, 256))
OTHER_BATCHES = (256, 64, 8, 1)


def other_shapes(fa, n: int) -> int:
    """K8 against its second design at other (m, ks, B) over n random rows:
    the route, the plan, the profiler's device time of each in two rounds
    (new, old, old, new), each first checked bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    for m, ks in OTHER_SHAPES:
        codes = torch.randint(0, ks, (n, m), generator=gen, device="cuda").to(torch.uint8)
        for b in OTHER_BATCHES:
            lut = torch.rand(b, m, ks, generator=gen, device="cuda")
            want = fa.adc_topk_candidates_ref(codes, lut)
            pair = {"new": lambda: fa.k8_candidates(codes, lut),
                    "old": lambda: fa.k8_v2_candidates(codes, lut)}
            for fn in pair.values():
                got = fn()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    print(f"m={m} ks={ks} B={b}: differs from the plain version", flush=True)
                    return 1
            dev = {"new": [], "old": []}
            for which in ("new", "old", "old", "new"):
                match = "adc_ring" if which == "new" else "adc_qlane_candidates"
                dev[which].append(device_ms(pair[which], 5, match))
            print(f"m={m} ks={ks} B={b}: route {fa.k8_route(m, ks, b)}, {fa.k8_plan(m, ks, b)}; "
                  f"device {np.mean(dev['new']):.4f} ms (rounds {dev['new']}), second design "
                  f"{np.mean(dev['old']):.4f} ms (rounds {dev['old']}); "
                  f"{np.mean(dev['old']) / np.mean(dev['new']):.2f}x", flush=True)
        del codes
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
