#!/usr/bin/env python3
"""Sweep of the flat scan's wgmma design (K1/K2/K11 on Hopper's tensor cores)
over bf16 row widths on one GPU, against the narrow tile's plan and the first
tensor-core design.

    python3 scripts/ab_scan_wgmma_torch.py [--dims 100,128,136,...,8192]
                                           [--batches 8,256] [--rounds 3] [--no-earlier]
                                           [--out build/ab_scan_wgmma.json]

Builds the port's kernels and prints `nvcc -Xptxas -v`'s stack frame, spills
and registers of every wgmma-design kernel instance, the highest register
each instance's SASS names (beside the launch bound's 168 a thread:
setmaxnreg raises the consumers to 224) and its calls, and the CUDA runtime's
registers and local (spilled) bytes; then, for each width d and batch B (2^20
slots, 1,000,000 live gaussian bf16 rows made on the card from a seed, L2,
k = 10), times K1 and K2 under wgmma_plan's own plan (through the
`bin_candidates` / `count_below` wrappers: the route a flat index takes),
under the narrow tile's plan where the route's differs (past one query tile:
two query tiles a CTA, resident or from registers, or two ring tiles a
chunked stage at one, through wgmma_plan's hand arguments), under each other
variant that fits (the query block's k chunk riding in each stage at one or
two 64-query tiles, beside one ring tile's k chunk (the first chunked
design), two or four, each in its own accumulator, with 1, 2, 3, 4 or 6 slabs
a stage and as many stages as fit; resident in shared memory at one), and
(unless --no-earlier) in the earlier design of these rows: the first
tensor-core design (`*_mma_v1`) up to d = 2,400, its route, and the FMA design
on the CUDA cores (`bin_candidates_fma` / `count_below_fma`, the route of bf16
rows past 2,400 before the tensor cores took them) past it, in `--rounds`
rounds of turns (the order rotates each round): CUDA events over enough
launches for about 20 ms. Every wgmma variant's K1 is first checked bit for
bit against the plan's own (the placement does not change the floats), and
K2's counts under the narrow tile's plan against its own's. At d = 128 and
B = 256 it also times K11 (tiles 4096 and 8192) against its first design. A
width where d % 8 != 0 (d = 100, 300) has rows TMA cannot address, so the
producer copies them. Each row prints its byte bound and, beside it, the
bytes the plan moves from L2 to the SMs (every CTA's class rows, and its
query rows where they ride in the stages), in all and a CTA (one CTA an
SM), and the shared-memory bytes a CTA moves (smem_bytes: the products'
operand reads, the wide tile's A fragment reads, TMA's writes), under the
route's plan and the narrow tile's. The card's name and power limit come
first (nvidia-smi); a JSON summary goes to --out. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED, K, N, LIVE = 4321, 10, 1 << 20, 1_000_000
HBM_BYTES_S, BF16_FLOPS = 3.35e12, 989e12
TREE_TILES = (4096, 8192)
METRICS = {"0": "l2", "1": "ip", "2": "cos"}
MODES = {"0": "top3", "1": "tree", "2": "count"}
WGMMA_RE = re.compile(r"scan_wgmma_kernelILi(\d)ELi(\d)ELi(\d+)ELi(\d)ELi(\d)E")


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def make_rows(d: int):
    """(x [N, d] bf16, sq [N] f32, valid [N]): LIVE gaussian rows, dead slots
    past them."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + d)
    x = torch.zeros(N, d, dtype=torch.bfloat16, device="cuda")
    for s in range(0, LIVE, 1 << 18):  # in slices: no f32 copy of the corpus
        e = min(s + (1 << 18), LIVE)
        x[s:e] = torch.randn(e - s, d, generator=gen, device="cuda").bfloat16()
    sq = torch.empty(N, device="cuda")
    for s in range(0, N, 1 << 18):
        xf = x[s : s + (1 << 18)].float()
        sq[s : s + (1 << 18)] = (xf * xf).sum(dim=1)
    return x, sq, torch.arange(N, device="cuda") < LIVE


def bound_ms(d: int, b: int) -> tuple:
    """The least time of one K1/K2 pass: its bytes (rows, bias, queries) at the
    HBM rate, or its bf16 products at the dense peak."""
    t_bytes = (N * (2 * d + 4) + 4 * b * d) / HBM_BYTES_S
    t_ops = 2.0 * b * N * d / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def l2_bytes(sf, p, d: int) -> float:
    """Bytes a pass under plan p brings from L2 into the SMs: each CTA's
    class rows of every tile, and the query block's rows with each stage
    where they ride in them (chunked: once for the stage's tps tiles)."""
    slab_bytes = sf._slabs(d) * sf.WG_SLAB * 2
    ctas = p.qblocks * (sf.C // p.g)
    rows = p.g + (64 * p.qt / p.tps if p.chunked else 0)
    return float(ctas * (N // sf.C) * rows * slab_bytes)


def smem_bytes(sf, p, d: int) -> float:
    """Shared-memory bytes a CTA of plan p moves in a pass, a model: each
    wgmma m64n32k16 reads its B (32 rows x 32 bytes) and, unless A is in
    registers, its A (64 x 32 bytes); the wide tile's chunked stages read
    their query chunk into A fragments once (64 qt rows x the stage's k
    values); TMA writes each stage's rows, query chunk and bias. Stages hold
    all their slabs where A comes from registers (TMA's zero fill)."""
    slabs = sf._slabs(d)
    nk = -(-slabs // p.cs) if p.chunked else 1
    groups = -(-p.tiles_per_split // p.tps)
    steps = 4 * p.cs  # k16 steps a stage (the last chunk's may be fewer without A in registers)
    wgmmas = 2 * p.units * p.tps * steps
    reads = wgmmas * (1024 + (0 if p.a_regs else 2048))
    a_loads = 64 * p.qt * p.cs * 128 if (p.chunked and p.a_regs) else 0
    writes = p.tps * p.g * p.cs * 128 + (64 * p.qt * p.cs * 128 if p.chunked else 0) + 8 * p.tps * p.g
    return float(groups * nk * (reads + a_loads + writes))


def rounds_in_turns(fns: dict, rounds: int) -> dict:
    """{name: [ms of each round]}: each round times every fn once, the order
    rotated by one each round."""
    names = list(fns)
    out = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            out[name].append(time_ms(fns[name]))
    return out


def ptxas_report() -> dict:
    """{instance: (ptxas's lines, highest register its SASS names, calls)}
    of every scan_wgmma_kernel<METRIC, MODE, KS, TPS, U> instance: `nvcc
    -Xptxas -v`'s stack frame, spills and registers, and from the instance's
    SASS (cuobjdump) the highest Rn, which shows whether the consumers' code
    uses more registers than the launch bound's 168 (setmaxnreg raises them
    to 224), and its CALL instructions (an epilogue not inlined)."""
    from vectorindex_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "scan_fused.o"
        out = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                              str(_build.CSRC / "scan_fused.cu")],
                             capture_output=True, text=True, check=True)
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)],
                              capture_output=True, text=True, check=True).stdout

    def label(mangled: str):
        m = WGMMA_RE.search(mangled)
        return None if m is None else (
            f"scan_wgmma_kernel<{METRICS[m.group(1)]},{MODES[m.group(2)]},KS={m.group(3)},"
            f"TPS={m.group(4)},U={m.group(5)}>")

    rows, name = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = label(m.group(1))
        elif name and ("Used" in line or "spill" in line):
            entry = rows.setdefault(name, ["", None, 0])
            entry[0] = "; ".join(filter(None, (entry[0], line.split(":", 1)[-1].strip())))
    for block in sass.split("Function : ")[1:]:
        name = label(block.split(None, 1)[0])
        if name:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", block)]
            entry = rows.setdefault(name, ["", None, 0])
            entry[1:] = [max(regs) if regs else None, len(re.findall(r"\bCALL\.", block))]
    for name, (line, top, calls) in sorted(rows.items()):
        print(f"ptxas {name}: {line}; SASS names registers up to R{top}, {calls} calls",
              flush=True)
    return rows


def narrow_plan(sf, b: int, d: int, kernel: str = "bin_candidates"):
    """The narrow tile's plan at (b, d), through wgmma_plan's hand arguments: two
    ring tiles a chunked stage at one query tile past the resident widths,
    at most two query tiles a CTA below them."""
    if sf.wgmma_plan(1, N, d).chunked:
        return sf.wgmma_plan(b, N, d, kernel=kernel, chunk_tiles=sf.WG_CHUNK_TILES)
    return sf.wgmma_plan(b, N, d, kernel=kernel, qt=min(2, -(-b // 64)),
                         chunk_tiles=sf.WG_CHUNK_TILES)


def variant_plans(sf, b: int, d: int) -> dict:
    """{label: plan} of the wgmma variants other than the plan's own that fit
    at (b, d): the narrow tile's plan ("narrow") where the route's wide tile differs;
    the query block's k chunk in each stage at one or two query tiles,
    beside one tile's k chunk a stage (the first chunked design), two or
    four (each in its own accumulator), or resident at one; where the plan
    is chunked at one query tile, 1, 2, 3, 4 or 6 slabs a stage (as many
    stages as fit)."""
    own = sf.wgmma_plan(b, N, d)
    out = {}
    old = narrow_plan(sf, b, d)
    if old != own:
        out["narrow"] = old
    if own.a_regs == 0:
        for label, kw in (("chunked", dict(a_mode="chunked")),
                          ("chunked qt=2", dict(a_mode="chunked", qt=2, chunk_tiles=2)),
                          ("chunked 1 tile", dict(a_mode="chunked", chunk_tiles=1)),
                          ("chunked 1 tile qt=2", dict(a_mode="chunked", chunk_tiles=1, qt=2)),
                          ("resident qt=1", dict(a_mode="smem", qt=1))):
            if kw.get("qt", 1) == 2 and b <= 64:
                continue
            p = sf.wgmma_plan(b, N, d, **kw)
            if p != own and p not in out.values() and (kw["a_mode"] == "chunked" or not p.chunked):
                out[label] = p
    if own.chunked and own.queue == 0:
        for cs in (1, 2, 3, 4, 6):
            stage, base = sf.wgmma_smem(d, own.qt, 0, True, cs, own.tps, 0)
            stages = min(sf.WG_MAX_STAGES, (sf.MAX_SMEM_BYTES - base) // stage)
            if cs != own.cs and stages >= 2:
                out[f"cs={cs}"] = own._replace(cs=cs, stages=stages, smem=base + stages * stage)
    return out


def sweep(sf, topk, d: int, b: int, rounds: int, x, sq, valid, earlier_too: bool = True) -> dict:
    from vectorindex_tpu_torch.utils.config import Metric

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7 * d + b)
    pick = torch.randint(0, LIVE, (b,), generator=gen, device="cuda")
    q = x[pick].float() + 0.1 * torch.randn(b, d, generator=gen, device="cuda")
    qk, bias, cs, _ = sf.kernel_inputs(q, sq, valid, Metric.L2)
    m = Metric.L2
    kd, ki = sf.bin_candidates(qk, x, bias, cs, metric=m)
    sd, _ = topk(kd.view(b, -1), K, ids=ki.view(b, -1), strict_ties=True)
    tau = sd[:, K - 1].contiguous()
    plans = variant_plans(sf, b, d)
    for label, p in plans.items():
        vd, vi = sf._wgmma_launch("bin_candidates", qk, x, bias, cs, m, plan=p)
        torch.cuda.synchronize()
        if not (torch.equal(vd, kd) and torch.equal(vi, ki)):
            raise AssertionError(f"d={d} B={b} {label}: K1's floats differ from the plan's own")
    # the earlier design of these rows: the first tensor-core design on its
    # route (d <= 2,400), the FMA design (CUDA cores) past it
    earlier = "mma_v1" if d <= 2400 else "fma"
    fns = {"K1 wgmma": lambda: sf.bin_candidates(qk, x, bias, cs, metric=m),
           "K2 wgmma": lambda: sf.count_below(qk, x, bias, cs, tau, metric=m)}
    if earlier_too:
        fns["K1 " + earlier] = lambda: getattr(sf, "bin_candidates_" + earlier)(
            qk, x, bias, cs, metric=m)
        fns["K2 " + earlier] = lambda: getattr(sf, "count_below_" + earlier)(
            qk, x, bias, cs, tau, metric=m)
    for label, p in plans.items():
        fns[f"K1 wgmma {label}"] = (lambda p=p: sf._wgmma_launch("bin_candidates", qk, x, bias,
                                                                 cs, m, plan=p))
        fns[f"K2 wgmma {label}"] = (lambda p=p: sf._wgmma_launch("count_below", qk, x, bias, cs,
                                                                 m, tau, plan=p))
    if d == 128 and b == 256:
        for tile in TREE_TILES:
            fns[f"K11 {tile} wgmma"] = (lambda t=tile: sf.bin_candidates_tree(
                qk, x, bias, metric=m, tile=t))
            fns[f"K11 {tile} wgmma resident"] = (lambda t=tile: sf._wgmma_launch(
                "bin_candidates_tree", qk, x, bias, None, m, tile=t, plan=sf.wgmma_plan(
                    b, N, d, block_tiles=t // sf.C, a_mode="smem", kernel="bin_candidates_tree")))
            fns[f"K11 {tile} first design"] = (lambda t=tile: sf.bin_candidates_tree_v1(
                qk, x, bias, metric=m, tile=t))
    if "narrow" in plans:  # K2 under its own plan too (K1's wide tile may hold fewer slabs)
        k2own = sf.wgmma_plan(b, N, d, kernel="count_below")
        k2old = narrow_plan(sf, b, d, "count_below")
        lt, le = sf._wgmma_launch("count_below", qk, x, bias, cs, m, tau, plan=k2own)
        olt, ole = sf._wgmma_launch("count_below", qk, x, bias, cs, m, tau, plan=k2old)
        torch.cuda.synchronize()
        if not (torch.equal(lt, olt) and torch.equal(le, ole)):
            raise AssertionError(f"d={d} B={b}: the wide tile changes K2's counts")
    times = rounds_in_turns(fns, rounds)
    own = sf.wgmma_plan(b, N, d)
    ctas = {k: p.qblocks * (sf.C // p.g) * p.splits for k, p in plans.items()}
    row = {"d": d, "B": b, "bound_ms": bound_ms(d, b), "plan": own._asdict(),
           "l2_gb": l2_bytes(sf, own, d) / 1e9,
           "l2_mb_a_cta": l2_bytes(sf, own, d) / 1e6 / (own.qblocks * (sf.C // own.g) * own.splits),
           "variant_l2_mb_a_cta": {k: l2_bytes(sf, p, d) / 1e6 / ctas[k] for k, p in plans.items()},
           "smem_mb_a_cta": smem_bytes(sf, own, d) / 1e6,
           "variant_smem_mb_a_cta": {k: smem_bytes(sf, p, d) / 1e6 for k, p in plans.items()},
           "earlier": earlier if earlier_too else None,
           "variants": {k: p._asdict() for k, p in plans.items()},
           "variant_l2_gb": {k: l2_bytes(sf, p, d) / 1e9 for k, p in plans.items()},
           "rounds": times}
    print(f"d={d} B={b}: plan {own}; bound {row['bound_ms'][0]:.4g} ms "
          f"({row['bound_ms'][1]}); L2->SM {row['l2_gb']:.4g} GB, "
          f"{row['l2_mb_a_cta']:.4g} MB a CTA; shared memory {row['smem_mb_a_cta']:.4g} MB a CTA",
          flush=True)
    for label, p in plans.items():
        print(f"  variant {label}: {p}; L2->SM {row['variant_l2_gb'][label]:.4g} GB, "
              f"{row['variant_l2_mb_a_cta'][label]:.4g} MB a CTA; shared memory "
              f"{row['variant_smem_mb_a_cta'][label]:.4g} MB a CTA", flush=True)
    for name, ms in times.items():
        print(f"  {name}: mean {sum(ms) / len(ms):.4f} ms, rounds {[round(v, 4) for v in ms]}",
              flush=True)
    for k in ("K1", "K2"):
        for other in ([earlier] if earlier_too else []) + (["wgmma narrow"] if "narrow" in plans else []):
            new, old = times[f"{k} wgmma"], times[f"{k} {other}"]
            verdict = ("faster in every round" if max(new) < min(old) else
                       "slower in every round" if min(new) > max(old) else "rounds cross")
            print(f"  {k}: wgmma / {other} {sum(new) / sum(old):.3f} ({verdict})", flush=True)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dims", default="100,128,136,160,192,256,320,384,448,512,768,1024,1536,"
                                          "2400,3072,4096,8192")
    parser.add_argument("--batches", default="8,256")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--no-earlier", action="store_true",
                        help="skip the earlier design (the FMA design takes 62 ms at 4,096 B=256)")
    parser.add_argument("--out", default=str(ROOT / "build" / "ab_scan_wgmma.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(gpu_name_and_power(), flush=True)
    from vectorindex_tpu_torch.kernels import _build
    from vectorindex_tpu_torch.kernels import scan_fused as sf
    from vectorindex_tpu_torch.ops.topk import topk

    t0 = time.perf_counter()
    _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = ptxas_report()
    attrs = sf.wgmma_attributes()
    for key, (regs, local) in sorted(attrs.items()):
        print(f"attributes {key}: {regs} registers, {local} local bytes", flush=True)
    rows = []
    for d in (int(v) for v in args.dims.split(",")):
        x, sq, valid = make_rows(d)
        for b in (int(v) for v in args.batches.split(",")):
            rows.append(sweep(sf, topk, d, b, args.rounds, x, sq, valid, not args.no_earlier))
        del x, sq, valid
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"gpu": gpu_name_and_power(), "rows": rows, "ptxas": ptxas,
                               "attributes": {str(k): v for k, v in attrs.items()}}, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
