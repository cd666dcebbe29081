#!/usr/bin/env python3
"""A/B of the flat scan's pass 1 on one GPU: the port of scripts/ab_flat_tree.py.

    python3 scripts/ab_flat_tree_torch.py [--iters 20] [--wgmma-rates]

Builds the port's kernels, then on one card and in one process times, at
the flat main path's shape (n = 1,000,000 gaussian rows rounded to bf16,
padded with dead rows to 2^20, d = 128, B = 256, k = 10, L2; seeded torch
data made on the card), with CUDA events over `iters` launches each, each
tensor-core kernel on the shipping wgmma design (scan_wgmma_kernel) and on
the first tensor-core design (scan_mma_kernel, the _v1 wrappers):

  K1: exact per-class top-3, the shipping pass 1 (the JAX script's
      "sorted2" reduction keeps 2 per class and tile and folds them into 3
      tiers; the port's K1 keeps the exact 3);
  K11 tree tile=4096 and tile=8192: one candidate per (class, block of
      `tile` rows), folded into 3 tiers (the script's "tree");
  K1 FMA design: the CUDA-core kernel (scan_fma_kernel, register-tiled)
      instantiated for bf16, and its first design (one thread a row), the
      design the tensor-core kernel replaced;
  K2 at tau = 1.0: pass 2 alone (the script's "p2").

Then the tree's exactness check (ab_flat_tree.py:184-202): K11 (tile 4096)
candidates -> top-k -> tau -> K2 -> flagged queries, and whether its ids
equal scan_topk_fused's on the queries exact in both, on each engine. It
also prints the registers and spills of the scan kernels (`nvcc -Xptxas
-v`; the wgmma kernels' consumers raise theirs by setmaxnreg to
scan_fused.WG_CONSUMER_REGS, 224) and
counts the tensor-core (HGMMA, HMMA) and FMA instructions in each scan
kernel's SASS (`cuobjdump -sass` of the built library). The card's name and
power limit come first (nvidia-smi). With --wgmma-rates it first builds
and runs scripts/wgmma_rates.cu: the clocks one wgmma m64nNk16 takes an SM
at N = 16, 32, 64, operands from shared memory or A from registers (the
measurement behind the wgmma design's N = 32). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N, NPAD, D, B, K, SEED = 1_000_000, 1 << 20, 128, 256, 10, 1234
MODES = {"0": "top3", "1": "tree", "2": "count"}
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


def kernel_label(mangled: str) -> str:
    """scan_wgmma_kernel<metric, mode, a_regs, tiles>, scan_mma_kernel<metric,
    mode> or the FMA kernels' names, from a mangled symbol."""
    m = re.search(r"scan_wgmma_kernelILi(\d)ELi(\d)ELi(\d)ELi(\d)E", mangled)
    if m:
        return (f"scan_wgmma_kernel<{METRICS[m.group(1)]},{MODES[m.group(2)]},{m.group(3)},"
                f"{m.group(4)}>")
    m = re.search(r"scan_mma_kernelILi(\d)ELi(\d)E", mangled)
    if m:
        return f"scan_mma_kernel<{METRICS[m.group(1)]},{MODES[m.group(2)]}>"
    m = re.search(r"(bin_candidates_kernel|count_below_kernel)I(f|13__nv_bfloat16)Li(\d)E", mangled)
    if m:
        dtype = "f32" if m.group(2) == "f" else "bf16"
        return f"{m.group(1)}<{dtype},{METRICS[m.group(3)]}>"
    m = re.search(r"scan_fma_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)ELi(\d)E", mangled)
    if m:
        dtype = "f32" if m.group(1) == "f" else "bf16"
        return f"scan_fma_kernel<{dtype},{METRICS[m.group(2)]},{MODES[m.group(3)]},{m.group(4)}>"
    return mangled


def build_report() -> None:
    """ptxas registers/spills of scan_fused.cu's kernels; HMMA/HGMMA/FFMA
    counts in their SASS."""
    from vectorindex_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              str(Path(tmp) / "scan_fused.o"), str(_build.CSRC / "scan_fused.cu")],
                             capture_output=True, text=True, check=True)
    name = None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif name and ("spill" in line or "Used" in line) and "kernel" in name:
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        name = kernel_label(block.split(None, 1)[0])
        if any(k in name for k in ("scan_wgmma", "scan_mma", "scan_fma", "bin_candidates_kernel",
                                   "count_below_kernel")):
            counts = {op: len(re.findall(rf"\b{op}\b", block)) for op in ("HGMMA", "HMMA", "FFMA")}
            print(f"sass {name}: " + ", ".join(f"{op} {c}" for op, c in counts.items()), flush=True)


def wgmma_rates() -> None:
    """Build scripts/wgmma_rates.cu into build/ and print its rates."""
    from vectorindex_tpu_torch.kernels import _build

    src = Path(__file__).resolve().parent / "wgmma_rates.cu"
    out = _build.BUILD_ROOT.parent / "wgmma_rates"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:4], "-o", str(out), str(src)],
                   check=True)
    run = subprocess.run([str(out)], capture_output=True, text=True, check=True, timeout=300)
    for line in run.stdout.splitlines():
        print(f"wgmma rate: {line}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--wgmma-rates", action="store_true",
                        help="first time wgmma m64nNk16 alone (scripts/wgmma_rates.cu)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_flat_tree_torch: no CUDA device", file=sys.stderr)
        return 1
    from vectorindex_tpu_torch.kernels import _build
    from vectorindex_tpu_torch.kernels import scan_fused as sf
    from vectorindex_tpu_torch.ops.topk import topk
    from vectorindex_tpu_torch.utils.config import Metric
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    print(f"gpu: {gpu_name_and_power()}", flush=True)
    if args.wgmma_rates:
        wgmma_rates()
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    build_report()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.zeros(NPAD, D, dtype=torch.bfloat16, device="cuda")
    x[:N] = torch.randn(N, D, generator=gen, device="cuda").bfloat16()
    valid = torch.arange(NPAD, device="cuda") < N
    xp, sq, vp = sf.pad_corpus(x, None, valid)
    q = torch.randn(B, D, generator=gen, device="cuda")
    qk, bias, _, _ = sf.kernel_inputs(q, sq, vp, Metric.L2)
    it = args.iters
    print(f"shape: n={N} padded to {NPAD}, d={D} bf16, B={B}, L2; mean of {it} launches", flush=True)
    print(f"plan: {sf.wgmma_plan(B, NPAD, D)}", flush=True)
    variants = [
        ("K1 wgmma (exact per-class top-3; sorted2's place)",
         lambda: sf.bin_candidates(qk, xp, bias, None, metric=Metric.L2)),
        ("K1 first tensor-core design (mma.sync)",
         lambda: sf.bin_candidates_mma_v1(qk, xp, bias, None, metric=Metric.L2)),
        ("K11 tree tile=4096 wgmma",
         lambda: sf.bin_candidates_tree(qk, xp, bias, metric=Metric.L2, tile=4096)),
        ("K11 tree tile=4096 first design",
         lambda: sf.bin_candidates_tree_v1(qk, xp, bias, metric=Metric.L2, tile=4096)),
        ("K11 tree tile=8192 wgmma",
         lambda: sf.bin_candidates_tree(qk, xp, bias, metric=Metric.L2, tile=8192)),
        ("K11 tree tile=8192 first design",
         lambda: sf.bin_candidates_tree_v1(qk, xp, bias, metric=Metric.L2, tile=8192)),
        ("K1 FMA design (CUDA cores, bf16)",
         lambda: sf.bin_candidates_fma(qk, xp, bias, None, metric=Metric.L2)),
        ("K1 first FMA design (CUDA cores, bf16)",
         lambda: sf.bin_candidates_fma_v1(qk, xp, bias, None, metric=Metric.L2)),
    ]
    ones = torch.ones(B, device="cuda")
    variants.append(("K2 wgmma count at tau=1.0",
                     lambda: sf.count_below(qk, xp, bias, None, ones, metric=Metric.L2)))
    variants.append(("K2 first tensor-core design count at tau=1.0",
                     lambda: sf.count_below_mma_v1(qk, xp, bias, None, ones, metric=Metric.L2)))
    for name, fn in variants:
        print(f"{name}: {time_ms(fn, it):.4f} ms", flush=True)

    fd, fi, fex = sf.scan_topk_fused(q, xp, sq, vp, metric=Metric.L2, k=K)
    same_all = True
    for engine, tree, count in (
            ("wgmma", sf.bin_candidates_tree, sf.count_below),
            ("first design", sf.bin_candidates_tree_v1, sf.count_below_mma_v1)):
        cd, ci = tree(qk, xp, bias, metric=Metric.L2, tile=4096)
        sd, si = topk(cd.view(B, -1), K, ids=ci.view(B, -1), strict_ties=True)
        tau = sd[:, K - 1].contiguous()
        lt, le = count(qk, xp, bias, None, tau, metric=Metric.L2)
        exact = (lt == (sd < tau[:, None]).sum(dim=1)) & (le == K)
        both = (exact & fex).cpu()
        same = ids_match_up_to_ties(si.cpu()[both], fi.cpu()[both], fd.cpu()[both], K)
        same_all &= same
        print(f"{engine}: tree tile=4096 flagged {int((~exact).sum())}/{B} queries; K1+K2 flagged "
              f"{int((~fex).sum())}/{B}; ids equal scan_topk_fused's on the {int(both.sum())} "
              f"queries exact in both: {same}", flush=True)
    print("DONE", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
