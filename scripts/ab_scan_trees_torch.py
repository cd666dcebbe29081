#!/usr/bin/env python3
"""K1/K2/K11 of the port in one checkout, timed at fixed shapes, to compare
two checkouts (a change and its parent) in turns on one GPU.

    python3 scripts/ab_scan_trees_torch.py --root <checkout> --label <name>
                                           [--out chiprun_out/trees.jsonl]

Imports vectorindex_tpu_torch from --root (its own kernels, built under
<root>/build/kernels at first use) and, by CUDA events over enough launches
for about 20 ms each, times through the route's wrappers (each kernel's own
plan in that checkout): K1 and K2 on the wgmma design over 2^20 bf16 rows
(1,000,000 live gaussian rows made on the card from a seed, L2, k = 10) at
d = 128 (B = 8, 64, 256; K11 at tiles 4,096 and 8,192, B = 256) and
d = 4,096 (B = 8, 64, 128, 256), and past 64 queries also under the narrow tile's
plan by wgmma_plan's hand arguments (two query tiles a CTA at d = 128, two
tiles a chunked stage at 4,096: "narrow" keys); K1 and K2 on the FMA design
over 2^20 x 128 f32 rows at B = 256 and 8. Appends one JSON line (the card, the label and
{shape: ms}) to --out. Run it on the parent and the change in turns
(parent, change, change, parent), each a process of its own. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED, K, N, LIVE = 4321, 10, 1 << 20, 1_000_000


def time_ms(fn, target_ms: float = 20.0) -> float:
    """CUDA-event ms a call of fn(), over enough calls for about target_ms."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    iters = max(3, min(200, int(target_ms / max(start.elapsed_time(stop), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def rows(d: int, dtype):
    gen = torch.Generator(device="cuda").manual_seed(SEED + d)
    x = torch.zeros(N, d, dtype=dtype, device="cuda")
    for s in range(0, LIVE, 1 << 17):
        e = min(s + (1 << 17), LIVE)
        x[s:e] = torch.randn(e - s, d, generator=gen, device="cuda").to(dtype)
    sq = torch.empty(N, device="cuda")
    for s in range(0, N, 1 << 17):
        xf = x[s : s + (1 << 17)].float()
        sq[s : s + (1 << 17)] = (xf * xf).sum(dim=1)
    return x, sq, torch.arange(N, device="cuda") < LIVE, gen


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--label", required=True)
    parser.add_argument("--out", default="chiprun_out/trees.jsonl")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from vectorindex_tpu_torch.kernels import _build
    from vectorindex_tpu_torch.kernels import scan_fused as sf
    from vectorindex_tpu_torch.ops.topk import topk
    from vectorindex_tpu_torch.utils.config import Metric

    assert Path(sf.__file__).resolve().is_relative_to(Path(args.root).resolve()), sf.__file__
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    m = Metric.L2
    out = {}
    shapes = ((128, torch.bfloat16, (8, 64, 256)), (4096, torch.bfloat16, (8, 64, 128, 256)),
              (128, torch.float32, (256, 8)))
    for d, dtype, batches in shapes:
        x, sq, valid, gen = rows(d, dtype)
        tag = "f32" if dtype == torch.float32 else "bf16"
        for b in batches:
            pick = torch.randint(0, LIVE, (b,), generator=gen, device="cuda")
            q = x[pick].float() + 0.1 * torch.randn(b, d, generator=gen, device="cuda")
            qk, bias, cs, _ = sf.kernel_inputs(q, sq, valid, m)
            kd, ki = sf.bin_candidates(qk, x, bias, cs, metric=m)
            sd, _ = topk(kd.view(b, -1), K, ids=ki.view(b, -1), strict_ties=True)
            tau = sd[:, K - 1].contiguous()
            key = f"{tag} d={d} B={b}"
            out[f"K1 {key}"] = time_ms(lambda: sf.bin_candidates(qk, x, bias, cs, metric=m))
            out[f"K2 {key}"] = time_ms(lambda: sf.count_below(qk, x, bias, cs, tau, metric=m))
            if tag == "bf16" and b > 64:
                old = (sf.wgmma_plan(b, N, d, qt=2) if d <= 448
                       else sf.wgmma_plan(b, N, d, chunk_tiles=2))
                out[f"K1 {key} narrow"] = time_ms(lambda: sf._wgmma_launch(
                    "bin_candidates", qk, x, bias, cs, m, plan=old))
                out[f"K2 {key} narrow"] = time_ms(lambda: sf._wgmma_launch(
                    "count_below", qk, x, bias, cs, m, tau, plan=old))
            if tag == "bf16" and d == 128 and b == 256:
                for tile in (4096, 8192):
                    out[f"K11 tile {tile} {key}"] = time_ms(
                        lambda t=tile: sf.bin_candidates_tree(qk, x, bias, metric=m, tile=t))
        del x, sq, valid
        torch.cuda.empty_cache()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    line = {"gpu": gpu, "label": args.label, "build_s": build_s, "ms": out}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
