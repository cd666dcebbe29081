#!/usr/bin/env python3
"""K2 on the band's wide tile with the slabs a chunked stage that keep its k
chunks (kernels/scan_fused._wgmma_ring: 2 chunks of 2 slabs at d = 193-256)
against the most slabs its ring fits (2 chunks of 3, two of them zero
slabs), in rounds of turns on one GPU.

    python3 scripts/ab_band_slabs_torch.py [--dims 224,256] [--batches 128,256] [--rounds 6]

For each width and batch (2^20 slots, 1,000,000 live gaussian bf16 rows made
on the card from a seed, L2, tau at K1's 10th candidate) it checks the two
plans count the same bit for bit, then times both by CUDA events
(scripts/ab_scan_wgmma_torch.py's rows, timer and rounds). The card's name
and power limit come first. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import ab_scan_wgmma_torch as ab  # noqa: E402  (puts the repository on sys.path)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dims", default="224,256")
    parser.add_argument("--batches", default="128,256")
    parser.add_argument("--rounds", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(ab.gpu_name_and_power(), flush=True)
    from vectorindex_tpu_torch.kernels import scan_fused as sf
    from vectorindex_tpu_torch.ops.topk import topk
    from vectorindex_tpu_torch.utils.config import Metric

    m = Metric.L2
    for d in (int(v) for v in args.dims.split(",")):
        x, sq, valid = ab.make_rows(d)
        for b in (int(v) for v in args.batches.split(",")):
            gen = torch.Generator(device="cuda").manual_seed(7 + d + b)
            pick = torch.randint(0, ab.LIVE, (b,), generator=gen, device="cuda")
            q = x[pick].float() + 0.1 * torch.randn(b, d, generator=gen, device="cuda")
            qk, bias, cs, _ = sf.kernel_inputs(q, sq, valid, m)
            kd, ki = sf.bin_candidates(qk, x, bias, cs, metric=m)
            sd, _ = topk(kd.view(b, -1), 10, ids=ki.view(b, -1), strict_ties=True)
            tau = sd[:, 9].contiguous()
            own = sf.wgmma_plan(b, ab.N, d, kernel="count_below")
            stage, base = sf.wgmma_smem(d, own.qt, 12, True, 3, own.tps, 0)
            stages = min(sf.WG_MAX_STAGES, (sf.MAX_SMEM_BYTES - base) // stage)
            most = own._replace(cs=3, a_regs=12, stages=stages, smem=base + stages * stage)
            plans = {f"{own.cs} slabs": own, "3 slabs": most}
            counts = [sf._wgmma_launch("count_below", qk, x, bias, cs, m, tau, plan=p)
                      for p in plans.values()]
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(*counts)):
                raise AssertionError(f"d={d} B={b}: the slab counts change K2's counts")
            t = ab.rounds_in_turns({k: (lambda p=p: sf._wgmma_launch(
                "count_below", qk, x, bias, cs, m, tau, plan=p)) for k, p in plans.items()},
                args.rounds)
            print(f"d={d} B={b}: " + "; ".join(
                f"K2 {k} x {plans[k].stages} stages min {min(v):.4f} mean {sum(v) / len(v):.4f} ms"
                for k, v in t.items()), flush=True)
        del x, sq, valid
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
