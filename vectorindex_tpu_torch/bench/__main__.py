"""Benchmark CLI of the port (reference VectorIndexBenchmarks/main.swift
flag surface :36-88: index selection, n/d/k/queries, index params, JSON
output modes). The flags and the JSON shapes are the JAX package's CLI's,
plus --device (default cuda: without a card it raises; pass --device cpu
to run on the host).

Usage:
  python -m vectorindex_tpu_torch.bench --index flat,ivf --n 10000 --d 64 --k 10
  python -m vectorindex_tpu_torch.bench --index all --out run.json --vb
  python -m vectorindex_tpu_torch.bench --microbench  # scoring rows/s & GB/s
  python -m vectorindex_tpu_torch.bench --device cpu --n 2000 --d 32
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import asdict

import torch

from vectorindex_tpu_torch.bench.harness import BenchResult, bench_index, make_run
from vectorindex_tpu_torch.bench.timing import resolve_device
from vectorindex_tpu_torch.utils.config import Metric

ALL_INDICES = ("flat", "hnsw", "ivf", "ivfpq")
#: the H100 SXM's HBM3 rate (NVIDIA's data sheet), the microbench's byte bound
HBM_BYTES_S = 3.35e12


def _suite(name: str, args) -> BenchResult:
    metric = Metric(args.metric)
    dev = args.device
    if name == "flat":
        from vectorindex_tpu_torch.models import FlatIndex

        return bench_index(
            lambda: FlatIndex(args.d, metric, device=dev),
            "flat", args.n, args.d, args.k, args.queries, metric,
            seed=args.seed, batch=args.batch, progress=args.progress, device=dev,
        )
    if name == "hnsw":
        from vectorindex_tpu_torch.models import HNSWConfig, HNSWIndex

        cfg = HNSWConfig(
            m=args.hnsw_m,
            ef_construction=args.hnsw_efc,
            ef_search=args.hnsw_efs,
        )
        return bench_index(
            lambda: HNSWIndex(args.d, metric, cfg, device=dev),
            "hnsw", args.n, args.d, args.k, args.queries, metric,
            seed=args.seed, batch=args.batch, progress=args.progress, device=dev,
            params={"m": cfg.m, "efC": cfg.ef_construction, "efS": cfg.ef_search},
        )
    if name == "ivf":
        from vectorindex_tpu_torch.models import IVFConfig, IVFIndex

        cfg = IVFConfig(nlist=args.ivf_nlist, nprobe=args.ivf_nprobe)
        return bench_index(
            lambda: IVFIndex(args.d, metric, cfg, device=dev),
            "ivf", args.n, args.d, args.k, args.queries, metric,
            seed=args.seed, batch=args.batch, progress=args.progress, device=dev,
            params={"nlist": cfg.nlist, "nprobe": cfg.nprobe},
        )
    if name == "ivfpq":
        from vectorindex_tpu_torch.models import IVFPQConfig, IVFPQIndex

        cfg = IVFPQConfig(
            nlist=args.ivf_nlist,
            nprobe=args.ivf_nprobe,
            m=args.pq_m,
            ks=args.pq_ks,
        )
        return bench_index(
            lambda: IVFPQIndex(args.d, metric, cfg, device=dev),
            "ivfpq", args.n, args.d, args.k, args.queries, metric,
            seed=args.seed, batch=args.batch, progress=args.progress, device=dev,
            params={
                "nlist": cfg.nlist, "nprobe": cfg.nprobe,
                "pq_m": cfg.m, "pq_ks": cfg.ks,
            },
        )
    raise SystemExit(f"unknown index: {name}")


def microbench(args) -> dict:
    """Kernel-level scoring microbench (reference L2SqrMicrobench/main.swift:
    6-13, 102-106: flags n/d/trials, reports rows/sec & GB/s): the squared
    L2 block of b bf16 queries against n bf16 rows (a tensor-core product,
    f32 epilogue, reduced to one sum), timed over `trials` distinct query
    slices (bench/timing.time_loop). bound_ms is the corpus read once at the
    H100's HBM rate; eager torch also writes and reads [b, n] intermediates."""
    from vectorindex_tpu_torch.bench.timing import time_loop
    from vectorindex_tpu_torch.ops import rng as vrng
    from vectorindex_tpu_torch.utils.telemetry import Telemetry

    dev = resolve_device(args.device)
    n, d, b = args.n, args.d, args.batch or 64
    gen = vrng.make_generator(0, 0, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    sqn = x.float().square().sum(dim=-1)
    qpool = torch.randn((args.trials * b, d), generator=vrng.split_stream(gen, 1),
                        device=dev).to(torch.bfloat16)

    def l2_block(q, x, sqn):
        g = torch.matmul(q, x.T).float()
        qd = q.float().square().sum(dim=-1)
        return ((qd[:, None] + sqn[None, :]).sub_(g, alpha=2.0).sum(),)

    repeats = 3
    per, _ = time_loop(l2_block, qpool, b, args.trials, repeats=repeats, args=(x, sqn),
                       device=dev)
    nbytes = n * d * x.element_size()
    rows_per_s = n * b / per
    gb_per_s = nbytes / per / 1e9
    calls = 1 + repeats * args.trials
    # a LOCAL recorder instance: the process-global TELEM must not be
    # force-enabled or polluted with this run's synthetic counters
    telem = Telemetry(enabled=True)
    telem.record_kernel("l2sqr_block", calls=calls, rows=n * b * calls, bytes=nbytes * calls)
    snap = telem.snapshot()
    kcounters = {
        k: v for k, v in snap["counters"].items() if k.startswith("kernel.")
    }
    name = f"{dev} {torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else str(dev)
    return {
        "kernel": "l2sqr_block",
        "n": n,
        "d": d,
        "batch": b,
        "ms_per_pass": round(per * 1e3, 3),
        "row_queries_per_s": round(rows_per_s),
        "corpus_gb_per_s": round(gb_per_s, 1),
        "bound_ms": nbytes / HBM_BYTES_S * 1e3,
        "bound_by": "bytes",
        "kernel_counters": kcounters,
        "device": name,
    }


def sweep(args) -> list:
    """Pareto sweep (recall@k vs QPS) over a search-time knob, one build:
    the index reads its reassigned `config` at the next search."""
    from vectorindex_tpu_torch.bench import datagen
    from vectorindex_tpu_torch.bench.harness import brute_force_topk, recall_at_k

    dev = args.device
    metric = Metric(args.metric)
    knob, values = args.sweep.split("=")
    values = [int(v) for v in values.split(",")]
    x = datagen.generate_clustered(args.n, args.d, seed=args.seed)
    q = datagen.queries_from(x, args.queries, noise=0.01, seed=args.seed + 1)
    ids = [f"v{i}" for i in range(args.n)]
    truth = brute_force_topk(x, q, args.k, metric, device=dev)

    name = args.index.split(",")[0]
    if name in ("ivf", "ivfpq") and knob == "nprobe":
        if name == "ivf":
            from vectorindex_tpu_torch.models import IVFConfig, IVFIndex

            idx = IVFIndex(args.d, metric, IVFConfig(nlist=args.ivf_nlist), device=dev)
            mk_cfg = lambda v: IVFConfig(nlist=args.ivf_nlist, nprobe=v)  # noqa: E731
        else:
            from vectorindex_tpu_torch.models import IVFPQConfig, IVFPQIndex

            idx = IVFPQIndex(
                args.d, metric,
                IVFPQConfig(nlist=args.ivf_nlist, m=args.pq_m, ks=args.pq_ks),
                device=dev,
            )
            mk_cfg = lambda v: IVFPQConfig(  # noqa: E731
                nlist=args.ivf_nlist, nprobe=v, m=args.pq_m, ks=args.pq_ks
            )
        idx.insert_batch(ids, x)
        idx.optimize()

        def set_knob(v):
            idx.config = mk_cfg(v)

    elif name == "hnsw" and knob == "efs":
        from vectorindex_tpu_torch.models import HNSWConfig, HNSWIndex

        idx = HNSWIndex(
            args.d, metric, HNSWConfig(m=args.hnsw_m, ef_construction=args.hnsw_efc),
            device=dev,
        )
        idx.insert_batch(ids, x)
        idx._ensure_built()

        def set_knob(v):
            idx.config = HNSWConfig(
                m=args.hnsw_m, ef_construction=args.hnsw_efc, ef_search=v
            )

    else:
        raise SystemExit(f"unsupported sweep {args.sweep!r} for index {name!r}")

    points = []
    for v in values:
        set_knob(v)
        res = idx.batch_search(q, args.k)  # warm (first launches at this knob)
        t0 = time.perf_counter()
        res = idx.batch_search(q, args.k)
        dt = time.perf_counter() - t0
        points.append(
            {
                "index": name,
                knob: v,
                "recall_at_k": round(recall_at_k(res, truth, lambda i: f"v{i}"), 4),
                "qps": round(args.queries / dt, 1),
                "ms_per_query": round(dt / args.queries * 1e3, 4),
            }
        )
    return points


def main(argv=None):
    """Run the CLI; prints the JSON payload (and writes it to --out) and
    returns it."""
    p = argparse.ArgumentParser(prog="vectorindex_tpu_torch.bench")
    p.add_argument("--index", default="flat", help="comma list or 'all'")
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--queries", type=int, default=100)
    p.add_argument("--metric", default="l2", choices=[m.value for m in Metric])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--hnsw-m", type=int, default=16)
    p.add_argument("--hnsw-efc", type=int, default=100)
    p.add_argument("--hnsw-efs", type=int, default=64)
    p.add_argument("--ivf-nlist", type=int, default=64)
    p.add_argument("--ivf-nprobe", type=int, default=8)
    p.add_argument("--pq-m", type=int, default=8)
    p.add_argument("--pq-ks", type=int, default=256)
    p.add_argument("--out", default=None, help="write JSON to file")
    p.add_argument("--vb", action="store_true", help="VectorBench run envelope")
    p.add_argument("--progress", action="store_true", help="JSON progress events to stderr")
    p.add_argument("--microbench", action="store_true", help="kernel-level bench")
    p.add_argument(
        "--sweep",
        default=None,
        help="recall/QPS tradeoff sweep: 'nprobe=1,8,32' (ivf/ivfpq) or "
        "'efs=16,64,128' (hnsw); builds once, varies the knob",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device of every index, truth and timing (default cuda; "
        "without a card it raises, pass 'cpu' to run on the host)",
    )
    args = p.parse_args(argv)
    resolve_device(args.device)

    if args.microbench:
        payload = microbench(args)
    elif args.sweep:
        payload = sweep(args)
    else:
        names = ALL_INDICES if args.index == "all" else tuple(args.index.split(","))
        results = [_suite(nm.strip(), args) for nm in names]
        payload = (
            asdict(make_run(results, device=args.device))
            if args.vb
            else [asdict(r) for r in results]
        )
    text = json.dumps(payload, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return payload


if __name__ == "__main__":
    main()
