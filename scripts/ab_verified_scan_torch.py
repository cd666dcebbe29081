#!/usr/bin/env python3
"""A/B of the flat index's two selections on one GPU: scan_topk_verified against scan_topk_strict.

    python3 scripts/ab_verified_scan_torch.py [--pairs 10] [--iters 5]

At capacity >= 2^17, models/flat sends what K1/K2 cannot take to
ops/scan.scan_topk_verified (a torch.topk of c = 256 candidates, their strict
top-k, and a flag on a query whose k-th distance ties its last candidate's)
instead of ops/scan.scan_topk_strict (a stable sort of the whole [B, N]
block). Both score the same distance block; the verified one trades the
sort for a fixed tail of small operations, so it wins only past some
B x N. This script times both at the two shapes chip_smoke.py drives the
route with, k = 10, over batches that span B x N = 2^20 to 2^26:

  - bf16 131,072 x 8,192 rows, L2 (the index models/flat now sends to K1/K2
    at k <= 512, and to this route at k > 512), B = 8, 16, 32, 64;
  - f32 1,048,576 x 128 rows, manhattan, B = 1, 2, 4, 8, 64.

Rows and queries are seeded gaussians drawn on the card (queries near rows).
Before timing, both selections must return the same distances and ids and
the verified one must flag no query (tie-free data). Then `--pairs` pairs,
alternating which side runs first, each side the mean of `--iters` calls by
CUDA events. Prints the card's name and power limit and one JSON line: per
shape and batch the medians, the quartiles, and the pairs each side won.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    MAIN_K, SEED, VERIFIED_DIM, VERIFIED_ROWS, gpu_name_and_power, time_ms,
)
from vectorindex_tpu_torch.ops.scan import scan_topk_strict, scan_topk_verified  # noqa: E402
from vectorindex_tpu_torch.utils.config import Metric  # noqa: E402

SHAPES = {
    "bf16_131072x8192_l2": (VERIFIED_ROWS, VERIFIED_DIM, torch.bfloat16, Metric.L2, (8, 16, 32, 64)),
    "f32_1048576x128_manhattan": (1 << 20, 128, torch.float32, Metric.MANHATTAN, (1, 2, 4, 8, 64)),
}


def corpus(n: int, d: int, dtype, nq: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    q = x[:nq].float() + 0.1 * torch.randn((nq, d), generator=gen, device="cuda")
    xf = x.float()
    sqn = (xf * xf).sum(dim=1)
    del xf
    inv = torch.where(sqn > 0, torch.rsqrt(torch.clamp_min(sqn, 1e-30)), 0.0)
    return x, q, sqn, inv


def quartiles(v) -> list:
    return [float(a) for a in np.percentile(v, [25, 50, 75])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_verified_scan_torch: no CUDA device", file=sys.stderr)
        return 1
    print(gpu_name_and_power(), flush=True)
    out = {}
    for name, (n, d, dtype, metric, batches) in SHAPES.items():
        x, qs, sqn, inv = corpus(n, d, dtype, max(batches), SEED + 40)
        for b in batches:
            q = qs[:b]
            sides = {
                "verified": lambda: scan_topk_verified(q, x, sqn, inv, None, metric=metric, k=MAIN_K),
                "strict": lambda: scan_topk_strict(q, x, sqn, inv, None, metric=metric, k=MAIN_K),
            }
            vd, vi, exact = sides["verified"]()
            sd, si = sides["strict"]()
            if not (exact.all() and torch.equal(vd, sd) and torch.equal(vi, si)):
                print(f"{name} B={b}: the selections differ", file=sys.stderr)
                return 1
            times = {side: [] for side in sides}
            for p in range(args.pairs):
                order = ("verified", "strict") if p % 2 == 0 else ("strict", "verified")
                for side in order:
                    times[side].append(time_ms(sides[side], args.iters, warmup=1))
            pairs = list(zip(times["verified"], times["strict"]))
            wins = sum(v < s for v, s in pairs)  # ties count for neither side
            out[f"{name}_B{b}"] = {
                "verified_q": quartiles(times["verified"]),
                "strict_q": quartiles(times["strict"]),
                "verified_wins": wins, "strict_wins": sum(s < v for v, s in pairs),
            }
            print(f"{name} B={b}: verified median {out[f'{name}_B{b}']['verified_q'][1]:.4g} ms, "
                  f"strict {out[f'{name}_B{b}']['strict_q'][1]:.4g} ms, verified faster in "
                  f"{wins} of {args.pairs} pairs", flush=True)
        del x, qs, sqn, inv
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
