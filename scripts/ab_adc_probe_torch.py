#!/usr/bin/env python3
"""A/B of the IVF-PQ probe kernel K9/K10 on one GPU: the probe-group design against the first one.

    python3 scripts/ab_adc_probe_torch.py [--iters 30] [--profiled 10] [--sessions 6]

Builds the port's kernels and chip_smoke.py's two IVF-PQ main paths
(IVFPQIndex nlist=4096, rerank_c=512 over lowdim_corpus(1M, 96, seed=31):
pq16, m=16 ks=256; pq32x4, m=32 ks=16 packed u4 with spill_eps=0.2), takes
the kernel's own inputs at pq16 B=8 (nprobe 32 and 8), pq16 B=256 and
pq32x4 B=8, and prints, in one process on one card:

  - the card's name and power limit, and `nvcc -Xptxas -v`'s registers,
    spills and shared memory for each instantiation in csrc/adc_probe.cu;
  - per case: kernels/adc_probe.probe_plan's G, the bound (chip_smoke's
    adc_bound), the lookup floor at the SM clock nvidia-smi reads under the
    kernel, and the LUT bytes each design reads (the first design: one LUT
    a CTA with a live row; the new one: one a CTA of G probes);
  - per case and launch plan: torch.profiler's device time per call and
    CUDA-event times in two rounds (forward, then reversed) of the first
    design (adc_probe_scores_v1) and of the new kernel at G = 1, 2, 4 and 8
    probes a CTA, each first checked bit for bit against the plain version;
  - per case: the new kernel at its plan and the first design in
    alternating profiler sessions (new, first, first, new, ...), each
    session's device time per call, and the mean, least and most of each;
  - the fused call (base and row_allow in the kernel's epilogue, a 10%
    allow_ids filter) against the unfused call plus the coarse-term add and
    the allow mask's passes as the search made them before the epilogue
    existed, by device time and events.

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
    PQ_BIG_BATCH, PQ_CONFIGS, PQ_DIM, PQ_NLIST, PQ_NPROBE, PQ_NPROBE_LOW, PQ_RERANK_C, PQ_ROWS,
    SMALL_BATCH, adc_bound, gpu_name_and_power, lookup_floor_ms, sm_clock_under, time_ms,
)
from vectorindex_tpu_torch.bench.synth import lowdim_corpus, lowdim_queries  # noqa: E402

#: kernels of csrc/adc_probe.cu by their names in ptxas and profiler output
KERNELS = ("adc_probe_group_kernel", "adc_probe_kernel")


def kernel_label(name: str) -> str:
    for k in KERNELS:
        if f"{len(k)}{k}" in name or re.search(rf"(^|[^a-z_]){k}", name):
            m = re.search(r"ILb([01])E(?:Lb([01])E)?", name)
            return f"{k}<{m.group(1)}{',' + m.group(2) if m and m.group(2) else ''}>" if m else k
    return name[:60]


def ptxas_report() -> None:
    """Registers, spills and stack of each instantiation in adc_probe.cu."""
    from vectorindex_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "adc_probe.o"), str(_build.CSRC / "adc_probe.cu")],
                             capture_output=True, text=True, check=True)
    name = None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif name and ("spill" in line or "Used" in line):
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)


def build_cases():
    """{label: (kernel args, kw, base, row_allow)} on both main paths' own
    tensors; row_allow is the 10% allow_ids filter of chip_smoke."""
    from vectorindex_tpu_torch.models.ivf import IVFPQConfig, IVFPQIndex
    from vectorindex_tpu_torch.ops import ivf as tivf
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.utils.config import Metric

    x, W = lowdim_corpus(PQ_ROWS, PQ_DIM, dz=16, seed=31)
    evalq = lowdim_queries(W, PQ_BIG_BATCH, seed=9)
    allow_ids = set(np.nonzero(np.random.default_rng(5).random(PQ_ROWS) < 0.10)[0].tolist())
    cases = {}
    for name, cfg in PQ_CONFIGS.items():
        t0 = time.perf_counter()
        idx = IVFPQIndex(
            PQ_DIM, Metric.L2,
            IVFPQConfig(nlist=PQ_NLIST, nprobe=PQ_NPROBE, m=cfg["m"], ks=cfg["ks"], rerank=True,
                        rerank_c=PQ_RERANK_C, spill_eps=cfg["spill_eps"]),
            storage_dtype=torch.float32, device="cuda")
        idx.insert_batch(list(range(PQ_ROWS)), x)
        idx.optimize()
        idx.batch_search(evalq[:SMALL_BATCH], 10)  # packs the lists and encodes every row
        arrays, codes, tcorr = idx._sync_pq()
        cap = tivf.probe_cap_for(idx._store.max_length)
        allow = idx._row_allow_mask(allow_ids, None)
        st = idx._store.list_stats()
        print(f"{name}: index built in {time.perf_counter() - t0:.1f} s, probe_cap {cap}, lists max "
              f"{st['max_len']}, mean {st['mean_len']:.1f}", flush=True)
        m, ks = cfg["m"], cfg["ks"]
        shapes = [(SMALL_BATCH, PQ_NPROBE)]
        if name == "pq16":
            shapes += [(SMALL_BATCH, PQ_NPROBE_LOW), (PQ_BIG_BATCH, PQ_NPROBE)]
        for b, nprobe in shapes:
            q = torch.from_numpy(evalq[:b]).cuda()
            base, lists = tivf.ivf_select(q, idx._centroids_dev, nprobe=nprobe, metric=idx.metric)
            lists = lists.long()
            args = (pq.pq_lut_q_l2(q, idx._books).contiguous(),
                    arrays.starts[lists].to(torch.int32).contiguous(),
                    arrays.lengths[lists].to(torch.int32).contiguous(), codes, tcorr)
            kw = dict(nprobe=nprobe, probe_cap=cap, m=m, ks=ks, packed_u4=ks <= 16)
            cases[f"{name} B={b} nprobe={nprobe}"] = (args, kw, base.float().contiguous(), allow)
        del idx
    return cases


def sweep_plans(ap, b: int, kw: dict) -> dict:
    """{label: G}: the plan's G, then G = 1, 2, 4 and 8 probes a CTA."""
    nprobe = kw["nprobe"]
    g = ap.probe_plan(b, nprobe, kw["probe_cap"], kw["m"], kw["ks"], kw["packed_u4"])
    plans = {"default": g}
    for g in (1, 2, 4, 8):
        if g <= nprobe and g not in plans.values():
            plans[f"G={g}"] = g
    return plans


def device_ms(fn, n: int) -> dict:
    """torch.profiler device time per call by kernel label."""
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
    return dict(per)


def lut_reads(args, kw, g: int) -> tuple:
    """LUT bytes read from L2 or memory per call: (first design, new at G)."""
    lives = args[2]
    b, nprobe = lives.shape
    lut_bytes = 4 * kw["m"] * kw["ks"]
    chunks_v1 = int(((lives.long() + 1023) // 1024).sum())  # CTAs with a live row
    return chunks_v1 * lut_bytes, b * -(-nprobe // g) * lut_bytes


def kernel_ms(fn, n: int) -> float:
    """Device time per call of csrc/adc_probe.cu's kernels alone (a session
    that records none of them is taken again, up to three times)."""
    for _ in range(3):
        ms = sum(v for k, v in device_ms(fn, n).items() if k.startswith(KERNELS))
        if ms > 0:
            return ms
    raise RuntimeError("three profiler sessions recorded no kernel of csrc/adc_probe.cu")


def unfused(ap, args, kw, base, allow):
    """The kernel without its epilogue, then the coarse-term add and the
    allow mask as the search applied them before the epilogue existed."""
    b, nprobe, cap = args[1].shape[0], kw["nprobe"], kw["probe_cap"]
    scores = ap.adc_probe_scores_rankseg if ap.adc_rankseg_fits(b) else ap.adc_probe_scores
    partial = scores(*args, **kw)
    dist = (partial.reshape(b, nprobe, cap) + base[:, :, None]).reshape(b, -1)
    slot_of = torch.clamp(args[1].long()[:, :, None] + torch.arange(cap, device=dist.device),
                          0, allow.shape[0] - 1)
    return torch.where(allow[slot_of].reshape(b, -1), dist, float("inf"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--profiled", type=int, default=10)
    parser.add_argument("--sessions", type=int, default=6,
                        help="alternating profiler sessions of the new kernel and the first design")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_adc_probe_torch: no CUDA device", file=sys.stderr)
        return 1
    from vectorindex_tpu_torch.kernels import _build
    from vectorindex_tpu_torch.kernels import adc_probe as ap

    print(f"gpu: {gpu_name_and_power()}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas_report()
    cases = build_cases()
    big = cases[f"pq16 B={PQ_BIG_BATCH} nprobe={PQ_NPROBE}"]
    clock = sm_clock_under(lambda: ap.adc_probe_scores(*big[0], **big[1]))
    print(f"sm clock under K9: {clock:.0f} MHz", flush=True)

    for label, (args, kw, base, allow) in cases.items():
        b = args[1].shape[0]
        ref = ap.adc_probe_scores_ref(*args, **kw)
        plan = ap.probe_plan(b, kw["nprobe"], kw["probe_cap"], kw["m"], kw["ks"], kw["packed_u4"])
        bms, by = adc_bound(args, kw["probe_cap"], kw["m"], kw["packed_u4"])
        lookups = kw["m"] * float(args[2].sum())
        v1_lut, new_lut = lut_reads(args, kw, plan)
        print(f"\n{label}: G={plan}; bound {bms:.5f} ms ({by}), half {bms / 2:.5f}; lookup floor "
              f"{lookup_floor_ms(lookups, clock):.5f} ms; LUT bytes read: first design {v1_lut}, "
              f"new {new_lut}; live rows {int(args[2].sum())}", flush=True)
        variants = {"first design": lambda: ap.adc_probe_scores_v1(*args, **kw)}
        for name, g in sweep_plans(ap, b, kw).items():
            variants[f"new {name} (G={g})"] = (
                lambda g=g: ap._launch("adc_probe_scores", *args, kw["probe_cap"], kw["m"], kw["ks"],
                                       kw["packed_u4"], probes=g))
        for name, fn in variants.items():
            if not torch.equal(fn(), ref):
                print(f"{label} {name}: differs from the plain version", flush=True)
                return 1
        fused_ref = ap.adc_probe_scores_ref(*args, **kw, base=base, row_allow=allow)
        calls = {
            "fused (base, allow in the kernel)":
                lambda: ap.adc_probe_scores(*args, **kw, base=base, row_allow=allow),
            "unfused (kernel, add, mask passes)": lambda: unfused(ap, args, kw, base, allow),
        }
        for name, fn in calls.items():
            if not torch.equal(fn(), fused_ref):
                print(f"{label} {name}: differs from the plain version", flush=True)
                return 1
        print(f"{label}: every variant equals the plain version bit for bit", flush=True)
        for name, fn in {**variants, **calls}.items():
            per = device_ms(fn, opts.profiled)
            ours = sum(v for k, v in per.items() if k.startswith(KERNELS))
            rest = sum(v for k, v in per.items() if not k.startswith(KERNELS))
            print(f"profiler {label} {name}: kernel {ours:.5f} ms a call, other device work "
                  f"{rest:.5f} ms", flush=True)
        times = {name: [] for name in {**variants, **calls}}
        every = {**variants, **calls}
        for order in (list(times), list(times)[::-1]):
            for name in order:
                times[name].append(time_ms(every[name], opts.iters))
        for name, r in times.items():
            print(f"events {label} {name}: {np.mean(r):.5f} ms (rounds {r[0]:.5f}, {r[1]:.5f})",
                  flush=True)
        # the plan against the first design in alternating profiler sessions
        pair = {"new": variants[f"new default (G={plan})"], "first design": variants["first design"]}
        sess = {name: [] for name in pair}
        for i in range(opts.sessions):
            for name in (("new", "first design") if i % 2 == 0 else ("first design", "new")):
                sess[name].append(kernel_ms(pair[name], opts.profiled))
        for name, r in sess.items():
            print(f"sessions {label} {name}: mean {np.mean(r):.6f} ms, least {min(r):.6f}, most "
                  f"{max(r):.6f} over {len(r)} sessions: {' '.join(f'{x:.6f}' for x in r)}",
                  flush=True)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
