#!/usr/bin/env python3
"""Smoke run of vectorindex_tpu_torch (the PyTorch/CUDA port) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, checks
each against its plain PyTorch version on the card (bit for bit, except K1,
K2 and K11 on gaussian bf16 rows: they sum on the tensor cores, so each
distance must lie within the tensor-core tolerance of utils/parity and the
counts within the rows that close to tau; on integer-valued bf16 rows, where
every partial sum is exact, they too agree bit for bit), and drives the
port's main paths with the launch counts set to 0 just before each and read
just after:

  flat: FlatIndex.insert_batch of 1,000,000 x 128 bf16 rows, then
        FlatIndex.batch_search with k=10 at B=256 and B=8 (K1, K2); recall@10
        against brute force, and no query may fall back to the strict path.
  flat A/B (scripts/ab_flat_tree_torch.py's path): K11 on the flat index's
        own tensors at B=256, tile 4096 and 8192; its tau through K2, the
        queries it flags, and its ids against scan_topk_fused's.
  IVF:  IVFIndex(nlist=1024, nprobe=32, bf16 storage).insert_batch of
        1,000,000 x 128 rows, optimize(), then batch_search at B=8 (K3; at
        nprobe 32 and 8, and with a 10% allow_ids filter), at B=256 (K4)
        and at B=8 with k=1000 (K5); ids against the exact search of the
        probed lists over an f32 copy of the store, recall@10 against brute
        force.
  IVF-PQ: IVFPQIndex(nlist=4096, nprobe=32, rerank_c=512) over 1,000,000 x
        96 rows, twice: pq16 (m=16, ks=256) searched at B=8 (K10; nprobe 32
        and 8, and with a 10% allow_ids filter) and at B=256 (K9), then
        pq32x4 (m=32, ks=16 packed u4) with spill_eps=0.2 at B=8 (K10 with
        dedup; every row must hold k distinct ids). insert_batch, optimize()
        and the first search (packing, encoding) are timed; ids against the
        same search through the kernels' plain versions, recall@10 against
        brute force (>= 0.85 and >= 0.90).
  ADC:  bench.py's bench_adc: PQ8x8 (pq_train 15 iters on 131,072 rows,
        pq_encode) of a 1,000,000 x 128 lowdim corpus; at B=256 the ADC-only
        top-10 and the exact f32 rerank of the ADC top-128 and top-512 (K8);
        range_scan_adc(strategy="auto") at B=64 with a radius from the data
        (K6); adc_scan_u4 over a pq16x4 encoding at B=64 (K7). Ids against
        the same calls through the plain versions, range ids and counts
        against a mask over K6's plain output, recall@10 against brute
        force (>= 0.95 after rerank512).

The flat path also runs FlatIndex.range_search on its index (a few queries,
one filtered), checked against brute force.

It checks the kernels against their plain versions again on each main
path's own tensors, and times the kernels, their plain versions and the
end-to-end searches with CUDA events. It imports nothing of JAX.

Output: one line per phase, the card's name and power limit (from
nvidia-smi), a JSON line describing each kernel, and last the line
{"ok": true, "device": {...}}. Any failed check raises, exiting non-zero;
without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
#: recall counts a hit when its brute-force distance is within this relative
#: band of the true k-th distance (distance ties, as ann-benchmarks counts)
RECALL_RTOL = 1e-5
#: kernel-vs-plain cases: N rows, 1/8 of them dead
CASE_ROWS = 262_144
#: main path: the headline flat configuration of bench.py (bench_flat)
MAIN_ROWS, MAIN_DIM, MAIN_K, MAIN_BATCH, MAIN_BATCHES = 1_000_000, 128, 10, 256, 4
SMALL_BATCH = 8
#: the device of the IVF phases (a rehearsal on the host may set "cpu")
DEVICE = "cuda"

#: IVF main path: the configuration of bench.py's bench_ivf (1M x 128,
#: nlist=1024) and README's IVF example; the corpus of bench/synth.lowdim_corpus
IVF_ROWS, IVF_DIM, IVF_NLIST, IVF_NPROBE, IVF_NPROBE_LOW = 1_000_000, 128, 1024, 32, 8
IVF_EVAL, IVF_BIG_BATCH, IVF_LARGE_K = 128, 256, 1000
IVF_RECALL_MIN = 0.90  # bench.py's operating threshold for IVF sweeps
#: IVF kernel-vs-plain cases: a store of 256 skewed lists, ~262k rows
IVF_CASE_LISTS, IVF_CASE_NPROBE, IVF_CASE_K4_BATCH, IVF_CASE_LONG = 256, 16, 64, 12_000

#: IVF-PQ main path: bench.py's bench_ivfpq (BASELINE config 4, README's
#: "IVF-PQ nlist=4096, 1M x 96" row) and its pq32x4 + spill variant
#: (bench.py:1905-1908); the corpus of bench/synth.lowdim_corpus, seed 31
PQ_ROWS, PQ_DIM, PQ_NLIST, PQ_NPROBE, PQ_NPROBE_LOW = 1_000_000, 96, 4096, 32, 8
PQ_RERANK_C, PQ_EVAL, PQ_BIG_BATCH, PQ_TIMED = 512, 128, 256, 20
PQ_CONFIGS = {
    "pq16": dict(m=16, ks=256, spill_eps=0.0, recall_min=0.85),
    "pq32x4": dict(m=32, ks=16, spill_eps=0.2, recall_min=0.90),
}
#: K9/K10 kernel-vs-plain cases over the skewed IVF store
PQ_CASE_NPROBE, PQ_CASE_BIG_BATCH = 16, 32

#: ADC main path: bench.py's bench_adc (BASELINE config 2): PQ8x8 over
#: bench/synth.lowdim_corpus(1M, 128, dz=16, seed=11), trained (15 Lloyd
#: iterations) on a 131,072-row sample of np.random.default_rng(0).choice,
#: queries lowdim_queries(W, 21 * 256): the first 256 evaluate, the other 20
#: batches time; ADC-only top-10 and an exact f32 rerank of the ADC top-C
ADC_ROWS, ADC_DIM, ADC_M, ADC_KS, ADC_ITERS, ADC_SAMPLE = 1_000_000, 128, 8, 256, 15, 131_072
ADC_BATCH, ADC_TIMED, ADC_RERANK = 256, 20, (128, 512)
ADC_RECALL_MIN = 0.95  # after rerank512; the TPU bench's adc line reads 0.9773
#: ADC range queries (K6) at B=64, the radius set so the median count is
#: ADC_RANGE_MEDIAN, into buffers of ADC_RANGE_MAX; the u4 scan (K7) over a
#: pq16x4 encoding of the same corpus at B=64
ADC_RANGE_BATCH, ADC_RANGE_MEDIAN, ADC_RANGE_MAX, ADC_U4_M, ADC_U4_KS = 64, 100, 128, 16, 16
#: K6/K7/K8 kernel-vs-plain cases: (m, ks) over a ragged row count
ADC_CASE_ROWS, ADC_CASES = 262_144 + 77, ((8, 256), (16, 256), (16, 16), (32, 16))
ADC_KERNELS = ("adc_scan_u8", "adc_scan_u4", "adc_topk_fused")
#: flat range search on the flat main path's index: queries, matches each
FLAT_RANGE_QUERIES, FLAT_RANGE_HITS = 4, 50

#: the H100 SXM's published peaks (NVIDIA's data sheet): bytes/s of HBM3,
#: bf16 tensor-core and f32 CUDA-core FLOP/s
HBM_BYTES_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12

SOURCES = {
    "bin_candidates": "vectorindex_tpu_torch/kernels/csrc/scan_fused.cu",
    "count_below": "vectorindex_tpu_torch/kernels/csrc/scan_fused.cu",
    "ivf_probe_topc": "vectorindex_tpu_torch/kernels/csrc/ivf_probe.cu",
    "ivf_probe_scores": "vectorindex_tpu_torch/kernels/csrc/ivf_probe.cu",
    "ivf_probe_scores_rankmajor": "vectorindex_tpu_torch/kernels/csrc/ivf_probe.cu",
    "adc_probe_scores": "vectorindex_tpu_torch/kernels/csrc/adc_probe.cu",
    "adc_probe_scores_rankseg": "vectorindex_tpu_torch/kernels/csrc/adc_probe.cu",
    "adc_scan_u8": "vectorindex_tpu_torch/kernels/csrc/adc.cu",
    "adc_scan_u4": "vectorindex_tpu_torch/kernels/csrc/adc.cu",
    "adc_topk_fused": "vectorindex_tpu_torch/kernels/csrc/adc.cu",
    "bin_candidates_tree": "vectorindex_tpu_torch/kernels/csrc/scan_fused.cu",
}
REPLACES = {
    "bin_candidates": "vectorindex_tpu/kernels/scan_fused.py:196",
    "count_below": "vectorindex_tpu/kernels/scan_fused.py:240",
    "ivf_probe_topc": "vectorindex_tpu/kernels/ivf_probe.py:794",
    "ivf_probe_scores": "vectorindex_tpu/kernels/ivf_probe.py:148",
    "ivf_probe_scores_rankmajor": "vectorindex_tpu/kernels/ivf_probe.py:892",
    "adc_probe_scores": "vectorindex_tpu/kernels/adc_probe.py:348",
    "adc_probe_scores_rankseg": "vectorindex_tpu/kernels/adc_probe.py:278",
    "adc_scan_u8": "vectorindex_tpu/kernels/adc.py:65",
    "adc_scan_u4": "vectorindex_tpu/kernels/adc.py:133",
    "adc_topk_fused": "vectorindex_tpu/kernels/adc.py:254",
    "bin_candidates_tree": "scripts/ab_flat_tree.py:110",
}
#: K11's blocks on the A/B path (the JAX script's two tiles)
TREE_TILES = (4096, 8192)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """Least time the card could take (ms) for this many bytes moved and
    operations done, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def same_row_err(kd, ki, rd, ri) -> float:
    """Largest |kernel - plain| over candidates that hold the same row at
    the same place on both sides."""
    same = (ki == ri) & torch.isfinite(kd) & torch.isfinite(rd)
    return float((kd - rd)[same].abs().max()) if same.any() else 0.0


def check_candidates(name, kd, ki, rd, ri, qk, x, bias, cs, metric, exact) -> float:
    """K1 or K11 candidates against the plain version's: equal bit for bit
    where `exact` (f32 corpora: one FMA chain per dot product on both sides;
    integer-valued bf16: every partial sum exact), else the tensor-core rule
    (utils/parity.tensor_core_candidates_ok). Returns the largest
    |kernel - plain| at the same row."""
    from vectorindex_tpu_torch.utils import parity

    err = same_row_err(kd, ki, rd, ri)
    if exact:
        require(torch.equal(kd, rd), f"{name}: candidate distances differ (max_abs_err {err})")
        require(torch.equal(ki, ri), f"{name}: candidate rows differ")
    else:
        ok, to_exact = parity.tensor_core_candidates_ok(kd, ki, rd, ri, qk, x, bias, cs, metric)
        require(ok, f"{name}: candidates outside the tensor-core tolerance (max |err| {to_exact})")
    return err


def check_counts(sf, qk, x, bias, cs, tau, klt, kle, metric, exact) -> int:
    """K2's counts against the plain version's at the same tau: equal where
    `exact`, else apart by at most the rows whose distance lies within the
    tensor-core tolerance of tau. Returns the largest difference."""
    from vectorindex_tpu_torch.utils import parity

    rlt, rle = sf.count_below_ref(qk, x, bias, cs, tau, metric=metric)
    torch.cuda.synchronize()
    diff = torch.maximum((klt - rlt).abs(), (kle - rle).abs())
    if exact:
        require(int(diff.max()) == 0, f"K2: counts differ from the plain version by up to {int(diff.max())}")
    else:
        near = parity.count_near(qk, x, bias, cs, tau, metric)
        require(bool((diff <= near).all()), "K2: counts differ by more than the rows near tau")
    return int(diff.max())


def check_identity(sf, qk, x, bias, cs, metric, kd):
    """K1 <-> K2 bit identity on these inputs: with tau at K1's sorted
    candidate distances (ranks 0, 9, 99 and the last finite), K2 counts
    every candidate at or below its own distance, and no row below K1's
    smallest."""
    b = kd.shape[0]
    sd, _ = torch.sort(kd.view(b, -1), dim=1)
    last = int(torch.isfinite(sd).sum(dim=1).min()) - 1
    for rank in sorted({0, 9, 99, last}):
        tau = sd[:, rank].contiguous()
        lt, le = sf.count_below(qk, x, bias, cs, tau, metric=metric)
        require(bool((le >= (sd <= tau[:, None]).sum(dim=1)).all()),
                f"K2 does not recompute K1's distances (tau at rank {rank})")
        require(rank != 0 or not bool(lt.any()), "K2 finds a row below K1's smallest distance")


def check_against_plain(sf, topk, qk, x, bias, cs, metric, kk=MAIN_K, exact=None):
    """K1 and K2 against their plain versions on the same inputs on the card.

    f32 corpora: both sides sum each dot product as one f32 FMA chain over d
    in order (the kernels' row_distances; cuBLAS's f32 GEMM with TF32 off for
    the plain versions), so they agree bit for bit. bf16 corpora: the
    kernels sum on the tensor cores; on integer-valued data (exact=True)
    every partial sum is exact and they agree bit for bit; otherwise the
    tensor-core rule holds (check_candidates, check_counts) and K1 <-> K2
    bit identity is checked on its own (check_identity). Returns (K1
    max_abs_err at the same rows, K2 max count difference, K1's tau [B]).
    """
    if exact is None:
        exact = x.dtype == torch.float32
    b = qk.shape[0]
    kd, ki = sf.bin_candidates(qk, x, bias, cs, metric=metric)
    torch.cuda.synchronize()
    rd, ri = sf.bin_candidates_ref(qk, x, bias, cs, metric=metric)
    torch.cuda.synchronize()
    k1_err = check_candidates("K1", kd, ki, rd, ri, qk, x, bias, cs, metric, exact)

    sd, _ = topk(kd.view(b, -1), kk, ids=ki.view(b, -1), strict_ties=True)
    tau = sd[:, kk - 1].contiguous()
    klt, kle = sf.count_below(qk, x, bias, cs, tau, metric=metric)
    torch.cuda.synchronize()
    # bit identity of K1 and K2: the kk selected rows all recount <= tau
    require(bool((kle >= kk).all()), "K2 does not recompute K1's distances")
    k2_err = check_counts(sf, qk, x, bias, cs, tau, klt, kle, metric, exact)
    if not exact:
        check_identity(sf, qk, x, bias, cs, metric, kd)
    return k1_err, k2_err, tau


def compare_case(sf, topk, metric, data, d, b, gen, device, n):
    from vectorindex_tpu_torch.utils.config import Metric
    from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

    if data == "bf16-int":
        # entries in [-8, 8]: every partial sum of d <= 128 products is an
        # integer below 2^24, exact in any order
        x = torch.randint(-8, 9, (n, d), generator=gen, device=device).float()
        q = torch.randint(-8, 9, (b, d), generator=gen, device=device).float()
    else:
        x = torch.randn(n, d, generator=gen, device=device)
        q = torch.randn(b, d, generator=gen, device=device)
    dtype = torch.float32 if data == "f32" else torch.bfloat16
    valid = torch.ones(n, dtype=torch.bool, device=device)
    valid[torch.randperm(n, generator=gen, device=device)[: n // 8]] = False
    x_pad, sq_pad, valid_pad = sf.pad_corpus(x.to(dtype), None, valid)
    qk, bias, cs, _ = sf.kernel_inputs(q, sq_pad, valid_pad, metric)
    if data == "bf16-int":
        # the kernel function on the integer queries themselves (cosine's
        # normalisation would make them inexact), K11 too
        k1_err, k2_err, _ = check_against_plain(sf, topk, q, x_pad, bias, cs, metric, exact=True)
        if metric != Metric.COSINE:
            for tile in TREE_TILES:
                kd, ki = sf.bin_candidates_tree(q, x_pad, bias, metric=metric, tile=tile)
                torch.cuda.synchronize()
                rd, ri = sf.bin_candidates_tree_ref(q, x_pad, bias, metric=metric, tile=tile)
                check_candidates("K11", kd, ki, rd, ri, q, x_pad, bias, None, metric, True)
        return k1_err, k2_err, None, None
    k1_err, k2_err, _ = check_against_plain(sf, topk, qk, x_pad, bias, cs, metric)

    # final top-k: kernel path on the card against the plain path on the
    # same inputs on the host, on rows both prove exact
    kk = MAIN_K
    kdist, kids, kex = sf.scan_topk_fused(q, x_pad, sq_pad, valid_pad, metric=metric, k=kk + 1)
    torch.cuda.synchronize()
    pdist, pids, pex = sf.scan_topk_fused(
        q.cpu(), x_pad.cpu(), sq_pad.cpu(), valid_pad.cpu(), metric=metric, k=kk + 1
    )
    both = (kex.cpu() & pex).nonzero().flatten()
    require(len(both) > 0, "no query proved exact on both paths")
    require(torch.allclose(kdist.cpu()[both], pdist[both], rtol=RTOL, atol=ATOL),
            "top-k distances differ")
    require(ids_match_up_to_ties(kids.cpu()[both], pids[both], pdist[both], kk),
            "top-k rows differ")
    return k1_err, k2_err, int(kex.sum()), int(pex.sum())


def phase_compare(sf, topk, device="cuda", n=CASE_ROWS):
    from vectorindex_tpu_torch.utils.config import Metric

    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"bin_candidates": 0.0, "count_below": 0, "bin_candidates_tree": 0.0}
    for metric in (Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE):
        for data in ("f32", "bf16-int", "bf16-gauss"):
            for d in (128, 100):
                for b in (SMALL_BATCH, MAIN_BATCH):
                    k1, k2, kex, pex = compare_case(sf, topk, metric, data, d, b, gen, device, n)
                    errs["bin_candidates"] = max(errs["bin_candidates"], k1)
                    errs["count_below"] = max(errs["count_below"], k2)
                    rule = "bit for bit" if data != "bf16-gauss" else "tensor-core tolerance"
                    tail = (f" exact kernel={kex}/{b} plain={pex}/{b}" if kex is not None
                            else " (K11 at tiles 4096, 8192 too)" if metric != Metric.COSINE else "")
                    log(f"compare {metric.value:6s} {data:10s} d={d} B={b}: {rule}, "
                        f"K1 max_abs_err={k1:.3g} K2 count diff={k2}{tail} ok")
    return errs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def bf16_exact(a: np.ndarray) -> np.ndarray:
    """Round to bf16 values, kept as f32: the corpus and the queries are
    exactly what bf16 storage holds, so brute force sees the same numbers."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def make_data(rows: int, dim: int, nq: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((rows + nq, dim), dtype=np.float32)
    held = data[rows:] + 0.1 * rng.standard_normal((nq, dim), dtype=np.float32)
    return bf16_exact(data[:rows]), bf16_exact(held)


def brute_force(x_dev, sq_dev, q: np.ndarray, k: int):
    """f32 squared-L2 distances to every row, stable sort -> (distances
    [B, N], true k-th distance [B], top-k ids [B, k])."""
    qd = torch.from_numpy(q).to(x_dev.device)
    dist = sq_dev[None, :] - 2.0 * (qd @ x_dev.T) + (qd * qd).sum(dim=1, keepdim=True)
    sd, order = torch.sort(dist, dim=1, stable=True)
    return dist, sd[:, k - 1], order[:, :k]


def recall(results, dist, kth, truth_ids, k: int):
    """(tie-aware recall, set recall) of one batch's results."""
    got = torch.tensor([[r.id for r in row] for row in results], device=dist.device)
    return recall_ids(got, dist, kth, truth_ids, k)


def recall_ids(got, dist, kth, truth_ids, k: int):
    """(tie-aware recall, set recall) of result ids [B, k]."""
    require(got.shape == (dist.shape[0], k), f"expected {k} results per query")
    got = got.long()
    d_got = torch.gather(dist, 1, got)
    hits = d_got <= kth[:, None] + RECALL_RTOL * kth.abs()[:, None]
    same = (got[:, :, None] == truth_ids[:, None, :]).any(dim=2)
    return float(hits.float().mean()), float(same.float().mean())


def phase_main(sf, device="cuda", rows=MAIN_ROWS, dim=MAIN_DIM):
    from vectorindex_tpu_torch.models.flat import FlatIndex
    from vectorindex_tpu_torch.utils.config import Metric
    from vectorindex_tpu_torch.utils.telemetry import TELEM

    nq = MAIN_BATCHES * MAIN_BATCH + SMALL_BATCH
    x, queries = make_data(rows, dim, nq)
    batches = [queries[i * MAIN_BATCH : (i + 1) * MAIN_BATCH] for i in range(MAIN_BATCHES)]
    batches.append(queries[MAIN_BATCHES * MAIN_BATCH :])

    idx = FlatIndex(dim, Metric.L2, storage_dtype=torch.bfloat16, device=device)
    t0 = time.perf_counter()
    idx.insert_batch(list(range(rows)), x)
    log(f"main: insert_batch {rows}x{dim} in {time.perf_counter() - t0:.2f} s, "
        f"capacity {idx.capacity}, dead slots {idx.capacity - idx.count}")

    TELEM.reset()
    TELEM.enable()
    sf.reset_launches()
    results = []
    for batch in batches:
        before = dict(sf.LAUNCHES)
        results.append(idx.batch_search(batch, MAIN_K))
        for name in ("bin_candidates", "count_below"):
            require(sf.LAUNCHES[name] > before[name], f"batch_search did not launch {name}")
    launches = {name: sf.LAUNCHES[name] for name in ("bin_candidates", "count_below")}
    TELEM.disable()
    counters = TELEM.snapshot()["counters"]
    fallback = counters.get("flat.verify_fallback", 0)
    log(f"main: {len(batches)} batches through K1+K2, launches {launches}, "
        f"strict fallback for {fallback} of {nq} queries")
    # the data is seeded and the kernels deterministic, and no query of it
    # needs the strict path: a flagged query here means K1 or K2 changed,
    # which the strict splice would otherwise hide from the recall check
    require(fallback == 0, f"{fallback} queries fell back to the strict path")

    x_dev = torch.from_numpy(x).to(device)
    sq_dev = (x_dev * x_dev).sum(dim=1)
    for batch, res in zip(batches, results):
        dist, kth, truth = brute_force(x_dev, sq_dev, batch, MAIN_K)
        for row in res:
            scores = [r.score for r in row]
            require(all(np.isfinite(scores)) and scores == sorted(scores),
                    "scores not finite and ascending")
        r_tie, r_set = recall(res, dist, kth, truth, MAIN_K)
        log(f"main: B={len(batch)} recall@{MAIN_K}={r_tie} (set recall {r_set})")
        require(r_tie == 1.0, f"recall@{MAIN_K} {r_tie} < 1")
    del x_dev, sq_dev
    return idx, batches, launches


# ---------------------------------------------------------------------------
# phase 4: times at the main-path shape
# ---------------------------------------------------------------------------


def phase_times(sf, topk, idx, batches, errs):
    """Check K1 and K2 against their plain versions on the main path's own
    tensors and queries (B=256 and B=8, so both grids; errs takes the
    larger errors), then time them."""
    from vectorindex_tpu_torch.utils.config import Metric

    x, sqn, _, valid = idx._sync_device()
    times = {}
    for batch in (batches[0], batches[-1]):
        b = len(batch)
        q = torch.from_numpy(batch).cuda()
        qk, bias, cs, _ = sf.kernel_inputs(q, sqn, valid, Metric.L2)
        k1, k2, tau = check_against_plain(sf, topk, qk, x, bias, cs, Metric.L2)
        errs["bin_candidates"] = max(errs["bin_candidates"], k1)
        errs["count_below"] = max(errs["count_below"], k2)
        log(f"main-shape check B={b}: K1 and K2 within the tensor-core tolerance of their plain "
            f"versions (K1 max_abs_err {k1:.3g} at the same rows, K2 count diff {k2}); K2 "
            "recomputes K1's distances bit for bit")
        args = (qk, x, bias, cs)
        t = {
            "bin_candidates": time_ms(lambda: sf.bin_candidates(*args, metric=Metric.L2), 10),
            "bin_candidates_plain": time_ms(
                lambda: sf.bin_candidates_ref(*args, metric=Metric.L2), 3),
            "count_below": time_ms(lambda: sf.count_below(*args, tau, metric=Metric.L2), 10),
            "count_below_plain": time_ms(
                lambda: sf.count_below_ref(*args, tau, metric=Metric.L2), 3),
        }
        idx.batch_search(batch, MAIN_K)  # warm
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            idx.batch_search(batch, MAIN_K)
            lat.append(time.perf_counter() - t0)
        t["search_ms_median"] = 1e3 * float(np.median(lat))
        t["qps"] = b / float(np.median(lat))
        times[b] = t
        log(f"times B={b} n={x.shape[0]} d={x.shape[1]} bf16 L2: " + ", ".join(
            f"{key}={val:.4g}" for key, val in t.items()))
    return times



def phase_tree(sf, topk, idx, batches, errs):
    """The A/B harness's path (scripts/ab_flat_tree_torch.py) on the flat
    main path's own tensors at B=256: K11 at both tiles with the launch
    counts set to 0 just before and read just after; then each against its
    plain version (the tensor-core rule), K2 on its tau (the queries it
    flags; its ids against scan_topk_fused's on queries exact in both), the
    times, and cuBLAS's bf16 product q x^T as the tensor-core floor of the
    product alone (not K11's function)."""
    from vectorindex_tpu_torch.utils.config import Metric
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    x, sqn, _, valid = idx._sync_device()
    q = torch.from_numpy(batches[0]).cuda()
    b = q.shape[0]
    qk, bias, _, _ = sf.kernel_inputs(q, sqn, valid, Metric.L2)
    sf.reset_launches()
    outs = {tile: sf.bin_candidates_tree(qk, x, bias, metric=Metric.L2, tile=tile)
            for tile in TREE_TILES}
    torch.cuda.synchronize()
    launches = sf.LAUNCHES["bin_candidates_tree"]
    require(launches == len(TREE_TILES), f"K11 did not run on its path: {sf.LAUNCHES}")
    fd, fi, fex = sf.scan_topk_fused(q, x, sqn, valid, metric=Metric.L2, k=MAIN_K)
    t = {}
    for tile, (kd, ki) in outs.items():
        rd, ri = sf.bin_candidates_tree_ref(qk, x, bias, metric=Metric.L2, tile=tile)
        err = check_candidates("K11", kd, ki, rd, ri, qk, x, bias, None, Metric.L2, False)
        errs["bin_candidates_tree"] = max(errs["bin_candidates_tree"], err)
        sd, si = topk(kd.view(b, -1), MAIN_K, ids=ki.view(b, -1), strict_ties=True)
        tau = sd[:, MAIN_K - 1].contiguous()
        lt, le = sf.count_below(qk, x, bias, None, tau, metric=Metric.L2)
        require(bool((le >= MAIN_K).all()), "K2 does not recompute K11's distances")
        exact = (lt == (sd < tau[:, None]).sum(dim=1)) & (le == MAIN_K)
        both = (exact & fex).cpu()
        require(ids_match_up_to_ties(si.cpu()[both], fi.cpu()[both], fd.cpu()[both], MAIN_K),
                f"K11 tile={tile}: ids differ from scan_topk_fused's on queries exact in both")
        t[tile] = {
            "ms": time_ms(lambda: sf.bin_candidates_tree(qk, x, bias, metric=Metric.L2, tile=tile), 10),
            "plain_ms": time_ms(lambda: sf.bin_candidates_tree_ref(qk, x, bias, metric=Metric.L2,
                                                                    tile=tile), 3),
            "flagged": int((~exact).sum()),
        }
        log(f"tree tile={tile} B={b}: K11 within the tensor-core tolerance of its plain version "
            f"(max_abs_err {err:.3g} at the same rows); flags {t[tile]['flagged']}/{b} queries "
            f"(K1+K2: {int((~fex).sum())}); ids equal scan_topk_fused's on the {int(both.sum())} "
            f"queries exact in both; kernel {t[tile]['ms']:.4g} ms, plain {t[tile]['plain_ms']:.4g} ms")
    qb = qk.to(torch.bfloat16)
    t["matmul_ms"] = time_ms(lambda: torch.matmul(qb, x.T), 10)
    log(f"tree: cuBLAS bf16 q x^T [{b}, {x.shape[0]}] (the product alone, bf16 out) "
        f"{t['matmul_ms']:.4g} ms; path launches {{'bin_candidates_tree': {launches}}}")
    return launches, t


# ---------------------------------------------------------------------------
# phase 5: the IVF kernels against their plain versions on the card
# ---------------------------------------------------------------------------


def probe_proof(cand_d, drop_min, kk: int = MAIN_K):
    """Per query, whether K3's selection is provably complete at kk (the
    search wrapper's rule)."""
    tau = torch.sort(cand_d, dim=1).values[:, kk - 1]
    dmin = drop_min.min(dim=1).values
    return torch.where(torch.isfinite(tau), dmin > tau, ~torch.isfinite(dmin))


def max_abs_err(a, b) -> float:
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[both].abs().max()) if both.any() else 0.0


def check_probe_kernels(kp, args_k3, args_k4, kw, b_small):
    """K3 and K5 on the K3-route inputs and K4 on the pair-route inputs
    against their plain versions: equal bit for bit (both compute each
    distance as one chain of separately rounded f32 products and sums, in
    d order, with a correctly rounded square root and division for
    cosine), K3's drop_min and proof flags included. Returns max_abs_err
    per kernel."""
    errs = {}
    got = kp.ivf_probe_topc_rankmajor(*args_k3, **kw)
    torch.cuda.synchronize()
    ref = kp.ivf_probe_topc_rankmajor_ref(*args_k3, **kw)
    errs["ivf_probe_topc"] = max(max_abs_err(got[0], ref[0]), max_abs_err(got[2], ref[2]))
    for name, a, r in zip(("distances", "rows", "drop_min"), got, ref):
        require(torch.equal(a, r), f"K3: {name} differ from the plain version (B={b_small})")
    require(torch.equal(probe_proof(got[0], got[2]), probe_proof(ref[0], ref[2])),
            "K3: proof flags differ")
    for name, fn, ref_fn, args in (
        ("ivf_probe_scores_rankmajor", kp.ivf_probe_scores_rankmajor,
         kp.ivf_probe_scores_rankmajor_ref, args_k3),
        ("ivf_probe_scores", kp.ivf_probe_scores, kp.ivf_probe_scores_ref, args_k4),
    ):
        a = fn(*args, **kw)
        torch.cuda.synchronize()
        r = ref_fn(*args, **kw)
        errs[name] = max_abs_err(a, r)
        require(torch.equal(a, r), f"{name}: distances differ from the plain version")
    return errs


def skewed_store(d: int, dtype, gen_seed: int):
    """256 lists of skewed lengths (8 empty, one of 12,000 rows, the rest
    lognormal around 1,000, at most 6,000), ~262k rows, packed on the card."""
    from vectorindex_tpu_torch.ops import ivf as tivf

    rng = np.random.default_rng(gen_seed)
    lengths = np.minimum(rng.lognormal(6.6, 0.8, IVF_CASE_LISTS), 6000).astype(np.int64)
    lengths[rng.choice(IVF_CASE_LISTS, 8, replace=False)] = 0
    lengths[int(np.argmax(lengths))] = IVF_CASE_LONG
    assign = np.repeat(np.arange(IVF_CASE_LISTS), lengths)
    centers = rng.standard_normal((IVF_CASE_LISTS, d), dtype=np.float32)
    x = centers[assign] + 0.5 * rng.standard_normal((len(assign), d), dtype=np.float32)
    store = tivf.IVFListStore(IVF_CASE_LISTS, d, device=DEVICE)
    store.append_batch(assign, np.arange(len(x)), x)
    arrays = store.sync_device(dtype)
    return arrays, tivf.probe_cap_for(store.max_length), torch.from_numpy(centers).to(DEVICE), len(x)


def probe_tables(q, centroids, arrays, nprobe, metric):
    from vectorindex_tpu_torch.ops import ivf as tivf

    _, lists = tivf.ivf_select(q, centroids, nprobe=nprobe, metric=metric)
    lists = lists.long()
    return arrays.starts[lists].contiguous(), arrays.lengths[lists].contiguous()


def phase_ivf_compare(kp):
    from vectorindex_tpu_torch.ops import ivf as tivf
    from vectorindex_tpu_torch.utils.config import Metric

    errs = dict.fromkeys(("ivf_probe_topc", "ivf_probe_scores", "ivf_probe_scores_rankmajor"), 0.0)
    for d in (128, 100):
        for dtype in (torch.float32, torch.bfloat16):
            arrays, cap, centers, n = skewed_store(d, dtype, d)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + d)
            allow = torch.rand(arrays.row_ids.shape[0], generator=gen, device=DEVICE) < 0.1
            sq_deny = torch.where(allow, arrays.sqnorms, float("inf")).contiguous()
            for metric in (Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE):
                qs = torch.randn(SMALL_BATCH + IVF_CASE_K4_BATCH, d, generator=gen, device=DEVICE)
                q8, q64 = qs[:SMALL_BATCH], qs[SMALL_BATCH:]
                kw = dict(nprobe=IVF_CASE_NPROBE, probe_cap=cap, metric=metric)
                args_k3 = (q8, *probe_tables(q8, centers, arrays, IVF_CASE_NPROBE, metric),
                           arrays.vecs, sq_deny)
                args_k4 = (q64, *probe_tables(q64, centers, arrays, IVF_CASE_NPROBE, metric),
                           arrays.vecs, arrays.sqnorms)
                case = check_probe_kernels(kp, args_k3, args_k4, kw, SMALL_BATCH)
                for name, e in case.items():
                    errs[name] = max(errs[name], e)
                log(f"ivf compare {metric.value:6s} {str(dtype)[6:]:8s} d={d} rows={n} "
                    f"cap={cap}: K3/K5 B={SMALL_BATCH} (10% allowed), K4 B={IVF_CASE_K4_BATCH} "
                    f"equal their plain versions bit for bit")
            del arrays, sq_deny
    # five equal rows in one class: K3's proof fails, the batch re-runs on K4
    x = 100.0 + np.random.default_rng(SEED).standard_normal((1280, 16)).astype(np.float32)
    x[[0, 256, 512, 768, 1024]] = 1.0
    store = tivf.IVFListStore(2, 16, device=DEVICE)
    store.append_batch(np.zeros(len(x), int), np.arange(len(x)), x)
    kp.reset_launches()
    _, ids = kp.ivf_search_flat_probe(
        torch.ones((1, 16), device=DEVICE), torch.zeros((2, 16), device=DEVICE),
        store.sync_device(), nprobe=1, probe_cap=tivf.probe_cap_for(store.max_length), k=5)
    fell_back = dict(kp.LAUNCHES)
    require(fell_back["ivf_probe_topc"] == 1 and fell_back["ivf_probe_scores"] == 1,
            f"class crowding did not fall back from K3 to K4: {fell_back}")
    require(sorted(ids[0].tolist()) == [0, 256, 512, 768, 1024], "crowded duplicates lost")
    log(f"ivf compare class crowding: K3 proof failed, K4 fallback launched ({fell_back}), "
        "the 5 duplicates returned")
    return errs


# ---------------------------------------------------------------------------
# phase 6: the IVF main path
# ---------------------------------------------------------------------------


def lowdim_corpus(n: int, d: int, dz: int = 16, noise: float = 0.05, seed: int = 42):
    """(x [n, d], W [dz, d]): unit-norm rows of intrinsic dimension dz, the
    SIFT-like corpus of the repo's IVF benchmark (numpy only)."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((dz, d), dtype=np.float32) / np.sqrt(dz)).astype(np.float32)
    z = rng.standard_normal((n, dz), dtype=np.float32)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= noise
    x += z @ W
    norms = np.sqrt(np.einsum("nd,nd->n", x, x))
    x /= np.maximum(norms, 1e-30)[:, None]
    return x, W


def lowdim_queries(W: np.ndarray, nq: int, noise: float = 0.05, seed: int = 9) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dz, d = W.shape
    q = rng.standard_normal((nq, dz), dtype=np.float32) @ W
    q += noise * rng.standard_normal((nq, d), dtype=np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    return q.astype(np.float32)


def ivf_reference(idx, q: np.ndarray, k: int, nprobe: int, row_allow=None):
    """Exact search of the probed lists over an f32 copy of the index's
    store on the card (ops/ivf.ivf_search_flat, the gather path) → (dist
    [B, k+1], ids [B, k+1]), ids being the index's slots."""
    from vectorindex_tpu_torch.ops import ivf as tivf

    p = idx._store._packed
    ref = tivf.IVFListArrays(*(torch.from_numpy(p[name]).to(DEVICE) for name in (
        "vecs", "row_ids", "sqnorms", "starts", "lengths")))
    dist, ids = tivf.ivf_search_flat(
        torch.from_numpy(q).to(DEVICE), idx._centroids_dev, ref, nprobe=nprobe,
        probe_cap=tivf.probe_cap_for(idx._store.max_length), k=k + 1, metric=idx.metric,
        row_allow=row_allow)
    return dist.cpu().numpy(), ids.cpu().numpy()


def check_ivf_batch(idx, res, q, k, nprobe, what, allow_ids=None):
    """The batch's ids equal, up to ties, the exact search of the probed
    lists; squared scores agree within RTOL/ATOL."""
    from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

    row_allow = None if allow_ids is None else idx._row_allow_mask(allow_ids, None)
    rd, ri = ivf_reference(idx, q, k, nprobe, row_allow)
    got = np.array([[r.id for r in row] for row in res])
    gd = np.array([[r.score for r in row] for row in res], dtype=np.float64) ** 2
    require(got.shape == (len(q), k), f"{what}: expected {k} results per query")
    require(np.allclose(gd, rd[:, :k], rtol=RTOL, atol=ATOL), f"{what}: distances differ")
    require(ids_match_up_to_ties(got, ri, rd, k), f"{what}: ids differ from the probed-list reference")


def phase_ivf_main(kp):
    from vectorindex_tpu_torch.models.ivf import IVFConfig, IVFIndex
    from vectorindex_tpu_torch.utils.config import Metric

    t0 = time.perf_counter()
    x, W = lowdim_corpus(IVF_ROWS, IVF_DIM, dz=16, seed=21)
    queries = lowdim_queries(W, IVF_EVAL + IVF_BIG_BATCH)
    evalq, bigq = queries[:IVF_EVAL], queries[IVF_EVAL:]
    log(f"ivf: corpus {IVF_ROWS}x{IVF_DIM} (lowdim dz=16, seed 21) in {time.perf_counter() - t0:.2f} s")
    idx = IVFIndex(IVF_DIM, Metric.L2, IVFConfig(nlist=IVF_NLIST, nprobe=IVF_NPROBE),
                   storage_dtype=torch.bfloat16, device=DEVICE)
    t0 = time.perf_counter()
    idx.insert_batch(list(range(IVF_ROWS)), x)
    t_insert = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.optimize()
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    log(f"ivf: insert_batch {t_insert:.2f} s, optimize (k-means|| seeding + Lloyd "
        f"{idx.config.train_iters} iters, seed {idx.config.seed}) {t_opt:.2f} s")
    frng = np.random.default_rng(5)
    allowed = np.nonzero(frng.random(IVF_ROWS) < 0.10)[0]
    allow_ids = set(allowed.tolist())
    batches = [evalq[i : i + SMALL_BATCH] for i in range(0, IVF_EVAL, SMALL_BATCH)]

    def run(q, k, route, **kw):
        before = dict(kp.LAUNCHES)
        res = idx.batch_search(q, k, **kw)
        grew = {n for n, c in kp.LAUNCHES.items() if c > before[n]}
        require(grew == {route}, f"batch B={len(q)} k={k} launched {grew}, expected {route}")
        return res

    idx.batch_search(batches[0], MAIN_K)  # packs the lists and the f32 rerank copy
    st = idx._store.list_stats()
    log(f"ivf: lists max {st['max_len']}, mean {st['mean_len']:.1f}, empty "
        f"{st['empty_lists']}, reserved rows {st['reserved_rows']}")
    kp.reset_launches()
    res = {}
    for nprobe in (IVF_NPROBE, IVF_NPROBE_LOW):
        idx.config = dataclasses.replace(idx.config, nprobe=nprobe)
        res[nprobe] = [run(b, MAIN_K, "ivf_probe_topc") for b in batches]
    idx.config = dataclasses.replace(idx.config, nprobe=IVF_NPROBE)
    res_big = run(bigq, MAIN_K, "ivf_probe_scores")
    res_filt = run(batches[0], MAIN_K, "ivf_probe_topc", allow_ids=allow_ids)
    res_large_k = run(batches[1], IVF_LARGE_K, "ivf_probe_scores_rankmajor")
    launches = dict(kp.LAUNCHES)
    log(f"ivf: main path launches {launches}")

    for nprobe, rows in res.items():
        for b, r in zip(batches, rows):
            check_ivf_batch(idx, r, b, MAIN_K, nprobe, f"ivf nprobe={nprobe}")
    check_ivf_batch(idx, res_big, bigq, MAIN_K, IVF_NPROBE, f"ivf B={IVF_BIG_BATCH}")
    check_ivf_batch(idx, res_filt, batches[0], MAIN_K, IVF_NPROBE, "ivf filtered", allow_ids)
    check_ivf_batch(idx, res_large_k, batches[1], IVF_LARGE_K, IVF_NPROBE, f"ivf k={IVF_LARGE_K}")
    log("ivf: every batch equals the exact search of its probed lists (f32 copy) up to ties")
    for row in res_filt:
        require(len(row) == MAIN_K and all(r.id in allow_ids for r in row),
                "filtered query returned fewer than k or a denied id")

    x_dev = torch.from_numpy(x).to(DEVICE)
    sq_dev = (x_dev * x_dev).sum(dim=1)
    recalls = {}
    for nprobe, rows in res.items():
        dist, kth, truth = brute_force(x_dev, sq_dev, evalq, MAIN_K)
        flat_rows = [row for batch in rows for row in batch]
        recalls[nprobe] = recall(flat_rows, dist, kth, truth, MAIN_K)
        log(f"ivf: nprobe={nprobe} recall@{MAIN_K}={recalls[nprobe][0]} "
            f"(set recall {recalls[nprobe][1]}) over {IVF_EVAL} queries")
    require(recalls[IVF_NPROBE][0] >= IVF_RECALL_MIN,
            f"recall@{MAIN_K} {recalls[IVF_NPROBE][0]} < {IVF_RECALL_MIN} at nprobe={IVF_NPROBE}")
    del x_dev, sq_dev
    return idx, batches, bigq, launches, {"insert_s": t_insert, "optimize_s": t_opt}


def distinct_rows(starts, lives) -> int:
    """Live rows of the distinct lists a batch probes (a list probed by
    several queries counts once)."""
    lists = torch.unique(starts.flatten())
    first = (starts.flatten()[None, :] == lists[:, None]).int().argmax(dim=1)
    return int(lives.flatten()[first].sum())


def probe_bound(kp, q, starts, lives, arrays, probe_cap, kernel):
    """(bound_ms, bound_by) of one probe kernel call: every live row of the
    distinct probed lists read once (d * itemsize + 4 bytes), q and the
    tables read, the output written once; 2 d operations per (query, row)."""
    b, d = q.shape
    itemsize = arrays.vecs.element_size()
    nbytes = distinct_rows(starts, lives) * (d * itemsize + 4) + q.numel() * 4 + starts.numel() * 8
    if kernel == "ivf_probe_topc":
        nbytes += b * kp.TIERS * kp.CBINS * 8 + b * kp.CBINS * 4
    else:
        nbytes += b * starts.shape[1] * probe_cap * 4
    flops = 2.0 * d * int(lives.sum())
    return bound(nbytes, flops, BF16_FLOPS if itemsize == 2 else F32_FLOPS)


def phase_ivf_times(kp, idx, batches, bigq, errs):
    """On the main path's own tensors: K3 and K5 at B=8 and K4 at B=256
    (nprobe=32) against their plain versions, then their times, bounds and
    the end-to-end batch_search latency."""
    from vectorindex_tpu_torch.ops import ivf as tivf

    arrays = idx._store.sync_device(idx.storage_dtype)
    cap = tivf.probe_cap_for(idx._store.max_length)
    kw = dict(nprobe=IVF_NPROBE, probe_cap=cap, metric=idx.metric)
    q8, q256 = torch.from_numpy(batches[0]).to(DEVICE), torch.from_numpy(bigq).to(DEVICE)
    args8 = (q8, *probe_tables(q8, idx._centroids_dev, arrays, IVF_NPROBE, idx.metric),
             arrays.vecs, arrays.sqnorms)
    args256 = (q256, *probe_tables(q256, idx._centroids_dev, arrays, IVF_NPROBE, idx.metric),
               arrays.vecs, arrays.sqnorms)
    for name, e in check_probe_kernels(kp, args8, args256, kw, SMALL_BATCH).items():
        errs[name] = max(errs[name], e)
    log("ivf main-shape check: K3, K5 (B=8) and K4 (B=256) equal their plain versions bit for bit")
    t = {}
    for name, fn, ref, args in (
        ("ivf_probe_topc", kp.ivf_probe_topc_rankmajor, kp.ivf_probe_topc_rankmajor_ref, args8),
        ("ivf_probe_scores_rankmajor", kp.ivf_probe_scores_rankmajor,
         kp.ivf_probe_scores_rankmajor_ref, args8),
        ("ivf_probe_scores", kp.ivf_probe_scores, kp.ivf_probe_scores_ref, args256),
    ):
        t[name] = time_ms(lambda: fn(*args, **kw), 50)
        t[name + "_plain"] = time_ms(lambda: ref(*args, **kw), 3, warmup=1)
        t[name + "_bound"] = probe_bound(kp, args[0], args[1], args[2], arrays, cap, name)
        log(f"ivf times {name} B={len(args[0])} nprobe={IVF_NPROBE}: kernel {t[name]:.4g} ms, "
            f"plain {t[name + '_plain']:.4g} ms, bound {t[name + '_bound'][0]:.4g} ms "
            f"({t[name + '_bound'][1]})")
    for q, nprobe in ((batches[0], IVF_NPROBE), (batches[0], IVF_NPROBE_LOW), (bigq, IVF_NPROBE)):
        label = f"B={len(q)} nprobe={nprobe}"
        idx.config = dataclasses.replace(idx.config, nprobe=nprobe)
        idx.batch_search(q, MAIN_K)  # warm
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            idx.batch_search(q, MAIN_K)
            lat.append(time.perf_counter() - t0)
        med = float(np.median(lat))
        t[f"search {label}"] = (1e3 * med, len(q) / med)
        log(f"ivf batch_search {label}: median {1e3 * med:.4g} ms, {len(q) / med:.1f} QPS")
    idx.config = dataclasses.replace(idx.config, nprobe=IVF_NPROBE)
    return t


# ---------------------------------------------------------------------------
# phase 7: the IVF-PQ kernels against their plain versions on the card
# ---------------------------------------------------------------------------

PQ_KERNELS = ("adc_probe_scores", "adc_probe_scores_rankseg")


def check_adc_kernels(ap, args, kw, what):
    """K9 and K10 against their plain versions on the same inputs: equal bit
    for bit (both add the m LUT entries in order from 0, each add rounded,
    then the row correction). Returns max_abs_err per kernel."""
    errs = {}
    for name in PQ_KERNELS:
        got = getattr(ap, name)(*args, **kw)
        torch.cuda.synchronize()
        ref = getattr(ap, name + "_ref")(*args, **kw)
        errs[name] = max_abs_err(got, ref)
        require(torch.equal(got, ref), f"{name}: {what} differs from the plain version")
    return errs


def phase_pq_compare(ap):
    """Random codes, row corrections and query LUTs over the skewed store
    (empty lists, one of 12,000 rows: probe_cap 16,384), u8 m=16 ks=256 and
    packed u4 m=32 ks=16, L2 and IP LUTs, B=8 and B=32."""
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.utils.config import Metric

    errs = dict.fromkeys(PQ_KERNELS, 0.0)
    arrays, cap, centers, n = skewed_store(PQ_DIM, torch.float32, PQ_DIM)
    require(cap >= 4096, f"probe_cap {cap} < 4096")
    n_rows = arrays.row_ids.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    for name, cfg in PQ_CONFIGS.items():
        m, ks = cfg["m"], cfg["ks"]
        codes = torch.randint(0, ks, (n_rows, m), generator=gen, device=DEVICE).to(torch.uint8)
        if ks <= 16:
            codes = pq.pack_u4(codes)
        books = pq.books_from_centroids(
            torch.randn(m, ks, PQ_DIM // m, generator=gen, device=DEVICE))
        for metric, lut_fn in ((Metric.L2, pq.pq_lut_q_l2), (Metric.INNER_PRODUCT, pq.pq_lut_ip)):
            tcorr = torch.randn(n_rows, generator=gen, device=DEVICE)
            if metric == Metric.INNER_PRODUCT:
                tcorr = torch.zeros_like(tcorr)
            for b in (SMALL_BATCH, PQ_CASE_BIG_BATCH):
                q = torch.randn(b, PQ_DIM, generator=gen, device=DEVICE)
                args = (lut_fn(q, books).contiguous(),
                        *probe_tables(q, centers, arrays, PQ_CASE_NPROBE, metric), codes, tcorr)
                kw = dict(nprobe=PQ_CASE_NPROBE, probe_cap=cap, m=m, ks=ks, packed_u4=ks <= 16)
                for k, e in check_adc_kernels(ap, args, kw, "a synthetic case").items():
                    errs[k] = max(errs[k], e)
            log(f"pq compare {name} (m={m} ks={ks}) {metric.value}: rows={n} cap={cap} "
                f"B={SMALL_BATCH} and B={PQ_CASE_BIG_BATCH}: K9 and K10 equal their plain "
                "versions bit for bit")
    return errs


# ---------------------------------------------------------------------------
# phase 8: the IVF-PQ main path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_versions(module, names):
    """Route a kernel module's wrappers `names` through their plain versions
    (on the same device tensors) while inside."""
    saved = {name: getattr(module, name) for name in names}
    for name in names:
        setattr(module, name, getattr(module, name + "_ref"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def same_results(got, want, k, what):
    """Ids equal up to ties of the reference distances; squared scores agree
    within RTOL/ATOL."""
    from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

    gi = np.array([[r.id for r in row] for row in got])
    wi = np.array([[r.id for r in row] for row in want])
    gd = np.array([[r.score for r in row] for row in got], dtype=np.float64) ** 2
    wd = np.array([[r.score for r in row] for row in want], dtype=np.float64) ** 2
    require(gi.shape == (len(got), k) and wi.shape == gi.shape, f"{what}: expected {k} results per query")
    require(np.allclose(gd, wd, rtol=RTOL, atol=ATOL), f"{what}: distances differ")
    require(ids_match_up_to_ties(gi, wi, wd, k), f"{what}: ids differ from the plain-version search")


def phase_pq_main(ap, name, x, evalq, bigq, truth):
    """Build the index, drive its searches with the launch counts set to 0
    just before and read just after, then check them."""
    from vectorindex_tpu_torch.models.ivf import IVFPQConfig, IVFPQIndex
    from vectorindex_tpu_torch.utils.config import Metric

    cfg = PQ_CONFIGS[name]
    idx = IVFPQIndex(
        PQ_DIM, Metric.L2,
        IVFPQConfig(nlist=PQ_NLIST, nprobe=PQ_NPROBE, m=cfg["m"], ks=cfg["ks"], rerank=True,
                    rerank_c=PQ_RERANK_C, spill_eps=cfg["spill_eps"]),
        storage_dtype=torch.float32, device=DEVICE)
    build = {}
    t0 = time.perf_counter()
    idx.insert_batch(list(range(PQ_ROWS)), x)
    build["insert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.optimize()
    torch.cuda.synchronize()
    build["optimize_s"] = time.perf_counter() - t0
    batches = [evalq[i : i + SMALL_BATCH] for i in range(0, PQ_EVAL, SMALL_BATCH)]
    t0 = time.perf_counter()
    idx.batch_search(batches[0], MAIN_K)  # packs the lists and encodes every row
    build["first_search_s"] = time.perf_counter() - t0
    st = idx._store.list_stats()
    log(f"{name}: insert_batch {build['insert_s']:.2f} s, optimize (coarse k-means, "
        f"{len(idx._slot_spill)} spill copies, residual PQ m={cfg['m']} ks={cfg['ks']}) "
        f"{build['optimize_s']:.2f} s, first search (pack + encode) {build['first_search_s']:.2f} s; "
        f"lists max {st['max_len']}, mean {st['mean_len']:.1f}, empty {st['empty_lists']}, "
        f"reserved rows {st['reserved_rows']}")
    frng = np.random.default_rng(5)
    allow_ids = set(np.nonzero(frng.random(PQ_ROWS) < 0.10)[0].tolist())

    def run(q, route, **kw):
        before = dict(ap.LAUNCHES)
        res = idx.batch_search(q, MAIN_K, **kw)
        grew = {n for n, c in ap.LAUNCHES.items() if c > before[n]}
        require(grew == {route}, f"{name} batch B={len(q)} launched {grew}, expected {route}")
        return res

    nprobes = (PQ_NPROBE, PQ_NPROBE_LOW) if name == "pq16" else (PQ_NPROBE,)
    searches = []  # (label, nprobe, queries, kwargs, results)
    ap.reset_launches()
    for nprobe in nprobes:
        idx.config = dataclasses.replace(idx.config, nprobe=nprobe)
        for i, b in enumerate(batches):
            searches.append((f"B=8 #{i} nprobe={nprobe}", nprobe, b, {},
                             run(b, "adc_probe_scores_rankseg")))
    idx.config = dataclasses.replace(idx.config, nprobe=PQ_NPROBE)
    if name == "pq16":
        searches.append((f"B={PQ_BIG_BATCH}", PQ_NPROBE, bigq, {}, run(bigq, "adc_probe_scores")))
        searches.append(("B=8 filtered", PQ_NPROBE, batches[0], dict(allow_ids=allow_ids),
                         run(batches[0], "adc_probe_scores_rankseg", allow_ids=allow_ids)))
    launches = dict(ap.LAUNCHES)
    log(f"{name}: main path launches {launches}")

    with plain_versions(ap, PQ_KERNELS):
        for label, nprobe, q, kw, res in searches:
            idx.config = dataclasses.replace(idx.config, nprobe=nprobe)
            same_results(res, idx.batch_search(q, MAIN_K, **kw), MAIN_K, f"{name} {label}")
            for row in res:
                ids = [r.id for r in row]
                require(len(set(ids)) == MAIN_K, f"{name} {label}: a row holds a duplicate id")
                require(not kw or all(i in allow_ids for i in ids), f"{name} {label}: a denied id")
    idx.config = dataclasses.replace(idx.config, nprobe=PQ_NPROBE)
    log(f"{name}: every batch equals the same search through the plain versions up to ties; "
        f"every row holds {MAIN_K} distinct ids")

    dist, kth, truth_ids = truth
    recalls = {}
    for nprobe in nprobes:
        rows = [row for label, npb, q, kw, res in searches
                if npb == nprobe and label.startswith("B=8 #") for row in res]
        recalls[nprobe] = recall(rows, dist, kth, truth_ids, MAIN_K)
        log(f"{name}: nprobe={nprobe} recall@{MAIN_K}={recalls[nprobe][0]} "
            f"(set recall {recalls[nprobe][1]}) over {PQ_EVAL} queries")
    require(recalls[PQ_NPROBE][0] >= cfg["recall_min"],
            f"{name}: recall@{MAIN_K} {recalls[PQ_NPROBE][0]} < {cfg['recall_min']} at nprobe={PQ_NPROBE}")
    build["recall"] = {npb: r[0] for npb, r in recalls.items()}
    return idx, batches, launches, build


def adc_bound(args, probe_cap, m, packed_u4):
    """(bound_ms, bound_by) of one K9/K10 call: each distinct probed row's
    codes and correction read once, the LUT and tables read, the output
    written once; m + 1 adds per (query, live row)."""
    lut, starts, lives = args[:3]
    mb = m // 2 if packed_u4 else m
    nbytes = (distinct_rows(starts, lives) * (mb + 4) + lut.numel() * 4 + starts.numel() * 8
              + starts.numel() * probe_cap * 4)
    return bound(nbytes, (m + 1) * float(lives.sum()), F32_FLOPS)


def phase_pq_times(ap, name, idx, batches, bigq, pool, errs):
    """On the main path's own tensors: K10 at B=8 (and K9 at B=256 for
    pq16) against their plain versions, then their times and bounds, and
    the median batch_search wall over PQ_TIMED batches of the timing pool."""
    from vectorindex_tpu_torch.ops import ivf as tivf
    from vectorindex_tpu_torch.ops import pq

    arrays, codes, tcorr = idx._sync_pq()
    cap = tivf.probe_cap_for(idx._store.max_length)
    m, ks = idx.config.m, idx.config.ks
    kw = dict(nprobe=PQ_NPROBE, probe_cap=cap, m=m, ks=ks, packed_u4=ks <= 16)

    def kernel_args(qnp):
        q = torch.from_numpy(qnp).to(DEVICE)
        return (pq.pq_lut_q_l2(q, idx._books).contiguous(),
                *probe_tables(q, idx._centroids_dev, arrays, PQ_NPROBE, idx.metric), codes, tcorr)

    cases = [("adc_probe_scores_rankseg", kernel_args(batches[0]))]
    if name == "pq16":
        cases.append(("adc_probe_scores", kernel_args(bigq)))
    t = {}
    for kname, args in cases:
        for k, e in check_adc_kernels(ap, args, kw, "the main path's tensors").items():
            errs[k] = max(errs[k], e)
        fn, ref = getattr(ap, kname), getattr(ap, kname + "_ref")
        t[kname] = time_ms(lambda: fn(*args, **kw), 50)
        t[kname + "_plain"] = time_ms(lambda: ref(*args, **kw), 3, warmup=1)
        t[kname + "_bound"] = adc_bound(args, cap, m, ks <= 16)
        log(f"{name} times {kname} B={args[0].shape[0]} nprobe={PQ_NPROBE} cap={cap}: kernel "
            f"{t[kname]:.4g} ms, plain {t[kname + '_plain']:.4g} ms, bound "
            f"{t[kname + '_bound'][0]:.4g} ms ({t[kname + '_bound'][1]})")
    log(f"{name} main-shape check: K9 and K10 equal their plain versions bit for bit")
    small = [pool[i * SMALL_BATCH : (i + 1) * SMALL_BATCH] for i in range(PQ_TIMED)]
    timed = [(SMALL_BATCH, PQ_NPROBE, small)]
    if name == "pq16":
        timed += [(SMALL_BATCH, PQ_NPROBE_LOW, small), (PQ_BIG_BATCH, PQ_NPROBE, [pool] * 10)]
    for b, nprobe, qs in timed:
        idx.config = dataclasses.replace(idx.config, nprobe=nprobe)
        idx.batch_search(qs[0], MAIN_K)  # warm
        lat = []
        for q in qs:
            t0 = time.perf_counter()
            idx.batch_search(q, MAIN_K)
            lat.append(time.perf_counter() - t0)
        med = float(np.median(lat))
        t[f"search B={b} nprobe={nprobe}"] = (1e3 * med, b / med)
        log(f"{name} batch_search B={b} nprobe={nprobe}: median {1e3 * med:.4g} ms over "
            f"{len(qs)} batches, {b / med:.1f} QPS")
    idx.config = dataclasses.replace(idx.config, nprobe=PQ_NPROBE)
    return t


def phase_pq(ap):
    """Both IVF-PQ configurations over one corpus → (launches summed over
    both main-path runs, pq16 times, pq32x4 times, build and recall figures)."""
    errs = phase_pq_compare(ap)
    t0 = time.perf_counter()
    x, W = lowdim_corpus(PQ_ROWS, PQ_DIM, dz=16, seed=31)
    evalq = lowdim_queries(W, PQ_BIG_BATCH, seed=9)
    pool = lowdim_queries(W, PQ_BIG_BATCH, seed=10)
    log(f"ivfpq: corpus {PQ_ROWS}x{PQ_DIM} (lowdim dz=16, seed 31) in {time.perf_counter() - t0:.2f} s")
    x_dev = torch.from_numpy(x).to(DEVICE)
    truth = brute_force(x_dev, (x_dev * x_dev).sum(dim=1), evalq[:PQ_EVAL], MAIN_K)
    del x_dev
    launches = dict.fromkeys(PQ_KERNELS, 0)
    times, builds = {}, {}
    for name in PQ_CONFIGS:
        idx, batches, run_launches, builds[name] = phase_pq_main(ap, name, x, evalq[:PQ_EVAL],
                                                                  evalq, truth)
        for k, c in run_launches.items():
            launches[k] += c
        times[name] = phase_pq_times(ap, name, idx, batches, evalq, pool, errs)
        del idx
        torch.cuda.empty_cache()
    return errs, launches, times, builds


# ---------------------------------------------------------------------------
# phase 9: exact range search on the flat main path's index
# ---------------------------------------------------------------------------


def phase_flat_range(idx, batches):
    """FlatIndex.range_search over the flat main path's 1M x 128 bf16 index
    (no kernel of its own: one distance block and a compaction). Each query's
    radius lies midway between its FLAT_RANGE_HITS-th and next brute-force
    distance; the hits must be those rows in brute-force order (up to
    ties), with squared scores within RTOL/ATOL, and a filter must hold."""
    from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

    x_dev = torch.from_numpy(idx._vectors).to(DEVICE)  # the bf16-exact rows as f32
    sq_dev = (x_dev * x_dev).sum(dim=1)
    live = torch.from_numpy(idx._valid).to(DEVICE)
    queries = batches[-1][:FLAT_RANGE_QUERIES]
    dist, _, _ = brute_force(x_dev, sq_dev, queries, 1)
    dist = torch.where(live[None, :], dist, float("inf"))
    sd, order = torch.sort(dist, dim=1, stable=True)
    walls = []
    for i, q in enumerate(queries):
        # the first rank from FLAT_RANGE_HITS on whose gap to the next is
        # far above f32 rounding, so no row lies near the radius
        h = FLAT_RANGE_HITS
        while float(sd[i, h] - sd[i, h - 1]) <= 1e-3 * float(sd[i, h]):
            h += 1
        r2 = 0.5 * float(sd[i, h - 1] + sd[i, h])
        flt = None
        want = order[i, :h].tolist()
        if i == 0:  # tag the matches and filter to half of them
            for rank, slot in enumerate(want):
                idx.update(idx._idmap.external_for(slot), metadata={"even": rank % 2 == 0})
            flt = lambda md: md is not None and md["even"]  # noqa: E731
            want = want[0::2]
        t0 = time.perf_counter()
        hits = idx.range_search(q, float(np.sqrt(r2)), max_results=2 * h, filter=flt)
        walls.append(time.perf_counter() - t0)
        got = [r.id for r in hits]
        wd = torch.gather(dist[i], 0, torch.tensor(want, device=DEVICE)).cpu().numpy()
        require(len(got) == len(want), f"range query {i}: {len(got)} hits, brute force {len(want)}")
        require(np.allclose(np.array([r.score for r in hits], dtype=np.float64) ** 2, wd,
                            rtol=RTOL, atol=ATOL), f"range query {i}: distances differ")
        require(ids_match_up_to_ties([got], [want], wd[None, :], len(want)),
                f"range query {i}: ids differ from brute force")
    log(f"flat range_search: {FLAT_RANGE_QUERIES} queries of >= {FLAT_RANGE_HITS} matches (one "
        f"filtered to the even ranks) equal brute force over 1M rows up to ties; wall per call "
        f"{1e3 * float(np.median(walls)):.4g} ms (median)")
    del x_dev, sq_dev
    return float(np.median(walls))


# ---------------------------------------------------------------------------
# phase 10: the full-corpus ADC kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_adc_compare(fa):
    """Random codes and non-negative LUTs over ADC_CASE_ROWS rows (a ragged
    last tile), B=8 and 64: K6 and K8 (k=10 and 512) on u8 codes, K7 on
    packed u4, against their plain versions. Equal bit for bit (one add
    order: j ascending from 0, each add rounded); K8's distances equal K6's
    at K8's rows, K7's equal K6's on the unpacked codes."""
    from vectorindex_tpu_torch.ops import pq

    errs = dict.fromkeys(ADC_KERNELS, 0.0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    n = ADC_CASE_ROWS
    for m, ks in ADC_CASES:
        codes = torch.randint(0, ks, (n, m), generator=gen, device=DEVICE).to(torch.uint8)
        packed = pq.pack_u4(codes) if ks <= 16 else None
        for b in (SMALL_BATCH, ADC_RANGE_BATCH):
            lut = torch.rand(b, m, ks, generator=gen, device=DEVICE)
            k6 = fa.adc_scan_u8(codes, lut)
            torch.cuda.synchronize()
            ref = fa.adc_scan_u8_ref(codes, lut)
            errs["adc_scan_u8"] = max(errs["adc_scan_u8"], max_abs_err(k6, ref))
            require(torch.equal(k6, ref), f"K6 m={m} ks={ks} B={b}: differs from the plain version")
            if packed is not None:
                k7 = fa.adc_scan_u4(packed, lut)
                torch.cuda.synchronize()
                ref = fa.adc_scan_u4_ref(packed, lut)
                errs["adc_scan_u4"] = max(errs["adc_scan_u4"], max_abs_err(k7, ref))
                require(torch.equal(k7, ref) and torch.equal(k7, k6),
                        f"K7 m={m} B={b}: differs from its plain version or from K6")
                continue
            for k in (MAIN_K, 2 * 256):
                kd, ki = fa.adc_topk_fused(codes, lut, k)
                torch.cuda.synchronize()
                rd, ri = fa.adc_topk_fused_ref(codes, lut, k)
                errs["adc_topk_fused"] = max(errs["adc_topk_fused"], max_abs_err(kd, rd))
                require(torch.equal(kd, rd) and torch.equal(ki, ri),
                        f"K8 m={m} B={b} k={k}: differs from the plain version")
                require(torch.equal(kd, torch.gather(k6, 1, ki.long())) and bool((ki < n).all()),
                        f"K8 m={m} B={b} k={k}: distances are not K6's at its rows")
        log(f"adc compare m={m} ks={ks} rows={n}: " + ("K7 (packed u4)" if packed is not None
            else "K6 and K8 (k=10, 512)") + f" at B={SMALL_BATCH} and B={ADC_RANGE_BATCH} "
            "equal their plain versions bit for bit")
    return errs


# ---------------------------------------------------------------------------
# phase 11: the ADC main path
# ---------------------------------------------------------------------------


def adc_build():
    """bench_adc's corpus, PQ8x8 books and codes, the pq16x4 books and packed
    codes of the same corpus, and the f32 rows for the rerank → dict."""
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.ops import rng as vrng

    t0 = time.perf_counter()
    x, W = lowdim_corpus(ADC_ROWS, ADC_DIM, dz=16, seed=11)
    queries = lowdim_queries(W, (ADC_TIMED + 1) * ADC_BATCH)
    st = {"corpus_s": time.perf_counter() - t0, "x": x, "queries": queries}
    x_dev = torch.from_numpy(x).to(DEVICE)
    samp = torch.from_numpy(np.random.default_rng(0).choice(ADC_ROWS, ADC_SAMPLE, replace=False))
    sample = x_dev[samp.to(DEVICE)]
    for name, m, ks, stream in (("books", ADC_M, ADC_KS, 0), ("books4", ADC_U4_M, ADC_U4_KS, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st[name] = pq.pq_train(vrng.make_generator(7, stream, device=DEVICE), sample, m=m, ks=ks,
                               iters=ADC_ITERS)
        torch.cuda.synchronize()
        st[name + "_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st["codes"] = pq.pq_encode(x_dev, st["books"], chunk=65536)
    torch.cuda.synchronize()
    st["encode_s"] = time.perf_counter() - t0
    st["packed"] = pq.pq_encode_u4(x_dev, st["books4"], chunk=65536)
    st["x_dev"], st["sq_dev"] = x_dev, (x_dev * x_dev).sum(dim=1)
    return st


def adc_search(fa, st, q, c: int):
    """bench_adc's search of a batch: f32 LUT, K8 top-c and, for c > k, the
    exact f32 rerank of the c candidates → (dist [B, k], rows [B, k])."""
    from vectorindex_tpu_torch.ops import ivf as tivf
    from vectorindex_tpu_torch.ops import pq

    lut = pq.pq_lut_l2(q, st["books"])
    d, rows = fa.adc_topk_fused(st["codes"], lut, c)
    if c == MAIN_K:
        return d, rows
    return tivf.rerank_exact_topk(q, rows, st["x_dev"], st["sq_dev"], k=MAIN_K)


def range_reference(plain, r2: float, mr: int):
    """The compaction of a mask over K6's plain output, on the host: per
    query the matches by (dist, id), the first mr, padded with INVALID_ID;
    and the counts."""
    from vectorindex_tpu_torch.ops.topk import INVALID_ID

    d = plain.cpu().numpy()
    ids = np.full((d.shape[0], mr), INVALID_ID, dtype=np.int64)
    counts = []
    for b in range(d.shape[0]):
        hit = np.nonzero(d[b] <= r2)[0]
        counts.append(len(hit))
        keep = hit[np.lexsort((hit, d[b][hit]))][:mr]
        ids[b, : len(keep)] = keep
    return torch.from_numpy(ids), torch.tensor(counts)


def phase_adc_main(fa, st):
    """Drive the ADC main path with the launch counts set to 0 just before
    and read just after, then check it."""
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.ops import range_query as rq

    queries = st["queries"]
    evalq = torch.from_numpy(queries[:ADC_BATCH]).to(DEVICE)
    q64 = evalq[:ADC_RANGE_BATCH]
    lut64 = pq.pq_lut_l2(q64, st["books"])
    lut4 = pq.pq_lut_l2(q64, st["books4"])
    # the radius: median over the queries of the ADC_RANGE_MEDIAN-th ADC distance
    plain64 = fa.adc_scan_u8_ref(st["codes"], lut64)
    r2 = float(torch.kthvalue(plain64, ADC_RANGE_MEDIAN, dim=1).values.median())
    radius = float(np.sqrt(np.float32(r2)))
    r2 = float(np.float32(radius) * np.float32(radius))  # range_query's f32 threshold

    fa.reset_launches()
    res = {c: adc_search(fa, st, evalq, c) for c in (MAIN_K, *ADC_RERANK)}
    rng_res = rq.range_scan_adc(st["codes"], lut64, radius, max_results=ADC_RANGE_MAX,
                                strategy="auto")
    u4 = pq.adc_scan_u4(st["packed"], lut4)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    log(f"adc: main path launches {launches}")
    require(all(launches[n] > 0 for n in ADC_KERNELS), f"a K6/K7/K8 kernel did not run: {launches}")

    with plain_versions(fa, ADC_KERNELS):
        for c, (_, ids) in res.items():
            _, want = adc_search(fa, st, evalq, c)
            require(torch.equal(ids, want), f"adc c={c}: ids differ from the plain-version search")
        require(torch.equal(u4, fa.adc_scan_u4(st["packed"], lut4)), "K7 differs from its plain version")
    require(torch.equal(u4, fa.adc_scan_u8(pq.unpack_u4(st["packed"]), lut4)),
            "K7 differs from K6 on the unpacked codes")
    log("adc: ADC-only and rerank 128/512 ids equal the same search through the plain versions; "
        "K7 equals its plain version and K6 on the unpacked codes")
    ref_ids, ref_counts = range_reference(plain64, r2, ADC_RANGE_MAX)
    counts = rng_res.counts.cpu()
    require(torch.equal(counts.long(), ref_counts), "range counts differ from K6's plain output")
    require(torch.equal(rng_res.ids.cpu().long(), ref_ids), "range ids differ from K6's plain output")
    live = rng_res.ids != 2**31 - 1
    require(torch.equal(rng_res.dists[live], torch.gather(plain64, 1, rng_res.ids.long().clamp_max(
        ADC_ROWS - 1))[live]), "range distances differ from K6's plain output")
    over = int((counts > ADC_RANGE_MAX).sum())
    log(f"adc: range radius {radius:.6g} (r^2 {r2:.6g}); counts median {float(counts.median())}, "
        f"min {int(counts.min())}, max {int(counts.max())}; {over} of {ADC_RANGE_BATCH} queries "
        f"overflow max_results={ADC_RANGE_MAX}; ids and counts equal a mask over K6's plain output")
    require(over > 0, "no range query overflowed its buffers")

    dist, kth, truth = brute_force(st["x_dev"], st["sq_dev"], queries[:ADC_BATCH], MAIN_K)
    recalls = {}
    for c, (_, ids) in res.items():
        recalls[c] = recall_ids(ids, dist, kth, truth, MAIN_K)
        label = "ADC-only" if c == MAIN_K else f"rerank{c}"
        log(f"adc: {label} recall@{MAIN_K}={recalls[c][0]} (set recall {recalls[c][1]}) over "
            f"{ADC_BATCH} queries")
    require(recalls[ADC_RERANK[-1]][0] >= ADC_RECALL_MIN,
            f"rerank{ADC_RERANK[-1]} recall@{MAIN_K} {recalls[ADC_RERANK[-1]][0]} < {ADC_RECALL_MIN}")
    del dist, truth
    return launches, {"recall": {c: r[0] for c, r in recalls.items()}}, (evalq, q64, lut64, lut4)


def adc_bounds(n: int, b: int, m: int, ks: int, mb: int, k: int = 0):
    """(bound_ms, bound_by) of K6/K7 (k=0: a [B, n] f32 output) or K8 (a
    [B, k] top-k): the codes and LUTs read once, the output written once;
    B * n * m f32 adds."""
    out = b * k * 8 if k else b * n * 4
    return bound(n * mb + b * m * ks * 4 + out, float(b) * n * m, F32_FLOPS)


def phase_adc_times(fa, st, tensors, errs):
    """K6/K7 at B=64 and K8 at B=256 on the main path's tensors: against
    their plain versions, times and bounds; K6 + a stable top-10 of its
    [256, 1M] output as K8's scan-then-select yardstick; embedding_bag as
    K6's library call; then the median wall of the B=256 searches."""
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.ops.topk import topk

    evalq, q64, lut64, lut4 = tensors
    codes, packed = st["codes"], st["packed"]
    lut256 = pq.pq_lut_l2(evalq, st["books"])
    n = codes.shape[0]
    t = {}
    k8 = fa.adc_topk_fused(codes, lut256, MAIN_K)
    k6_256 = fa.adc_scan_u8(codes, lut256)
    torch.cuda.synchronize()
    require(torch.equal(k8[0], torch.gather(k6_256, 1, k8[1].long())),
            "K8's distances are not K6's at its rows (B=256)")
    ref8 = fa.adc_topk_fused_ref(codes, lut256, MAIN_K)
    require(torch.equal(k8[0], ref8[0]) and torch.equal(k8[1], ref8[1]),
            "K8 differs from its plain version (B=256)")
    for name, fn, args in (("adc_scan_u8", "adc_scan_u8", (codes, lut64)),
                           ("adc_scan_u4", "adc_scan_u4", (packed, lut4))):
        got, ref = getattr(fa, fn)(*args), getattr(fa, fn + "_ref")(*args)
        require(torch.equal(got, ref), f"{name} differs from its plain version (main path)")
        errs[name] = max(errs[name], max_abs_err(got, ref))
    errs["adc_topk_fused"] = max(errs["adc_topk_fused"], max_abs_err(k8[0], ref8[0]))
    log("adc main-shape check: K6, K7 (B=64) and K8 (B=256) equal their plain versions bit for bit")
    del k6_256, ref8
    cases = (
        ("adc_scan_u8", lambda: fa.adc_scan_u8(codes, lut64), lambda: fa.adc_scan_u8_ref(codes, lut64),
         adc_bounds(n, ADC_RANGE_BATCH, ADC_M, ADC_KS, ADC_M)),
        ("adc_scan_u4", lambda: fa.adc_scan_u4(packed, lut4), lambda: fa.adc_scan_u4_ref(packed, lut4),
         adc_bounds(n, ADC_RANGE_BATCH, ADC_U4_M, ADC_U4_KS, ADC_U4_M // 2)),
        ("adc_topk_fused", lambda: fa.adc_topk_fused(codes, lut256, MAIN_K),
         lambda: fa.adc_topk_fused_ref(codes, lut256, MAIN_K),
         adc_bounds(n, ADC_BATCH, ADC_M, ADC_KS, ADC_M, MAIN_K)),
    )
    for name, fn, ref, bnd in cases:
        t[name] = time_ms(fn, 20)
        t[name + "_plain"] = time_ms(ref, 2, warmup=1)
        t[name + "_bound"] = bnd
        log(f"adc times {name}: kernel {t[name]:.4g} ms, plain {t[name + '_plain']:.4g} ms, "
            f"bound {bnd[0]:.4g} ms ({bnd[1]})")
    # K8's yardstick: scan then select (K6 at B=256, stable top-10 of [256, 1M])
    t["scan_then_topk"] = time_ms(lambda: topk(fa.adc_scan_u8(codes, lut256), MAIN_K), 5, warmup=1)
    # K6's library call: one embedding_bag over the subspace-offset codes with
    # the LUTs as a [m * ks, B] table (sum mode) computes [n, B]
    flat = (codes.long() + torch.arange(ADC_M, device=DEVICE) * ADC_KS).contiguous()
    table = lut64.reshape(ADC_RANGE_BATCH, -1).T.contiguous()
    emb = torch.nn.functional.embedding_bag(flat, table, mode="sum")
    require(torch.allclose(emb.T, fa.adc_scan_u8(codes, lut64), rtol=1e-5, atol=1e-5),
            "embedding_bag does not compute K6's function")
    t["adc_scan_u8_library"] = time_ms(
        lambda: torch.nn.functional.embedding_bag(flat, table, mode="sum"), 20)
    del flat, emb
    log(f"adc times: K6 + stable top-{MAIN_K} at B={ADC_BATCH} (scan then select) "
        f"{t['scan_then_topk']:.4g} ms; embedding_bag (K6's function at B={ADC_RANGE_BATCH}) "
        f"{t['adc_scan_u8_library']:.4g} ms")
    queries = st["queries"]
    pool = [torch.from_numpy(queries[(i + 1) * ADC_BATCH : (i + 2) * ADC_BATCH]).to(DEVICE)
            for i in range(ADC_TIMED)]
    for c in (MAIN_K, *ADC_RERANK):
        label = "adc_only" if c == MAIN_K else f"rerank{c}"
        adc_search(fa, st, pool[0], c)[1].cpu()  # warm
        lat = []
        for q in pool:
            t0 = time.perf_counter()
            adc_search(fa, st, q, c)[1].cpu()
            lat.append(time.perf_counter() - t0)
        med = float(np.median(lat))
        t[f"search {label}"] = (1e3 * med, ADC_BATCH / med)
        log(f"adc search B={ADC_BATCH} {label}: median {1e3 * med:.4g} ms over {ADC_TIMED} "
            f"batches, {ADC_BATCH / med:.1f} QPS")
    return t


def phase_adc(fa):
    """The ADC kernels against their plain versions, then the main path
    and its times → (errors, launches, times, build figures)."""
    errs = phase_adc_compare(fa)
    st = adc_build()
    log(f"adc: corpus {ADC_ROWS}x{ADC_DIM} (lowdim dz=16, seed 11) in {st['corpus_s']:.2f} s; "
        f"pq_train m={ADC_M} ks={ADC_KS} ({ADC_ITERS} iters, {ADC_SAMPLE} rows) "
        f"{st['books_train_s']:.2f} s, m={ADC_U4_M} ks={ADC_U4_KS} {st['books4_train_s']:.2f} s; "
        f"pq_encode of {ADC_ROWS} rows {st['encode_s']:.3f} s")
    launches, build, tensors = phase_adc_main(fa, st)
    times = phase_adc_times(fa, st, tensors, errs)
    build.update(train_s=st["books_train_s"], encode_s=st["encode_s"])
    return errs, launches, times, build


def flat_bound(n: int, d: int, b: int, itemsize: int, kernel: str):
    """(bound_ms, bound_by) of K1/K2 (K11: K1's) over the flat main path's
    corpus: rows, bias and q read once, the candidates or counts written."""
    nbytes = n * (d * itemsize + 4) + b * d * 4
    nbytes += b * 3 * 256 * 8 if kernel == "bin_candidates" else b * 12
    return bound(nbytes, 2.0 * b * n * d, BF16_FLOPS if itemsize == 2 else F32_FLOPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vectorindex_tpu_torch.kernels import _build, adc as fa, adc_probe as ap, ivf_probe as kp
    from vectorindex_tpu_torch.kernels import scan_fused as sf
    from vectorindex_tpu_torch.ops.topk import topk

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must stay off")
    gpu = gpu_name_and_power()
    log(f"gpu: {gpu}")

    t0 = time.perf_counter()
    _build.load()
    log(f"build: nvcc and load in {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")

    errs = phase_compare(sf, topk)
    idx, batches, launches = phase_main(sf)
    times = phase_times(sf, topk, idx, batches, errs)
    launches["bin_candidates_tree"], tree_times = phase_tree(sf, topk, idx, batches, errs)
    range_s = phase_flat_range(idx, batches)
    n_flat, itemsize = idx.capacity, 2
    del idx, batches
    torch.cuda.empty_cache()

    errs.update(phase_ivf_compare(kp))
    ivf_idx, ivf_batches, bigq, ivf_launches, build_s = phase_ivf_main(kp)
    ivf_times = phase_ivf_times(kp, ivf_idx, ivf_batches, bigq, errs)
    launches.update(ivf_launches)
    del ivf_idx, ivf_batches, bigq
    torch.cuda.empty_cache()

    pq_errs, pq_launches, pq_times, pq_builds = phase_pq(ap)
    errs.update(pq_errs)
    launches.update(pq_launches)
    torch.cuda.empty_cache()

    adc_errs, adc_launches, adc_times, adc_figs = phase_adc(fa)
    errs.update(adc_errs)
    launches.update(adc_launches)

    big = times[MAIN_BATCH]
    kernels = []
    for name in ("bin_candidates", "count_below"):
        bms, by = flat_bound(n_flat, MAIN_DIM, MAIN_BATCH, itemsize, name)
        kernels.append({"name": name, "ms": big[name], "plain_ms": big[name + "_plain"],
                        "bound_ms": bms, "bound_by": by})
    bms, by = flat_bound(n_flat, MAIN_DIM, MAIN_BATCH, itemsize, "bin_candidates")
    kernels.append({"name": "bin_candidates_tree", "ms": tree_times[TREE_TILES[0]]["ms"],
                    "plain_ms": tree_times[TREE_TILES[0]]["plain_ms"], "bound_ms": bms,
                    "bound_by": by})
    for name in ("ivf_probe_topc", "ivf_probe_scores", "ivf_probe_scores_rankmajor"):
        bms, by = ivf_times[name + "_bound"]
        kernels.append({"name": name, "ms": ivf_times[name],
                        "plain_ms": ivf_times[name + "_plain"], "bound_ms": bms, "bound_by": by})
    for name in PQ_KERNELS:  # pq16's: K10 at B=8, K9 at B=256
        bms, by = pq_times["pq16"][name + "_bound"]
        kernels.append({"name": name, "ms": pq_times["pq16"][name],
                        "plain_ms": pq_times["pq16"][name + "_plain"], "bound_ms": bms,
                        "bound_by": by})
    for name in ADC_KERNELS:  # K6/K7 at B=64, K8 at B=256
        bms, by = adc_times[name + "_bound"]
        kernels.append({"name": name, "ms": adc_times[name], "plain_ms": adc_times[name + "_plain"],
                        "bound_ms": bms, "bound_by": by})
    # embedding_bag computes K6's function in one call; no single PyTorch
    # call computes a per-class top-3, a count below tau, distances (or
    # LUT-gather sums) over per-query probed row lists, or reads packed u4
    library = {"adc_scan_u8": adc_times["adc_scan_u8_library"]}
    for k in kernels:
        k.update(route="cuda", source=SOURCES[k["name"]], replaces=REPLACES[k["name"]],
                 launches=launches[k["name"]], max_abs_err=errs[k["name"]],
                 library_ms=library.get(k["name"]))
    require(all(k["launches"] > 0 for k in kernels), f"a kernel did not run on its path: {launches}")
    log(f"gpu: {gpu}; flat batch_search B={MAIN_BATCH}: {big['qps']:.1f} QPS; ivf insert_batch "
        f"{build_s['insert_s']:.2f} s, optimize {build_s['optimize_s']:.2f} s; ivfpq "
        + "; ".join(f"{name} recall@{MAIN_K} {b['recall']}, insert {b['insert_s']:.2f} s, optimize "
                    f"{b['optimize_s']:.2f} s" for name, b in pq_builds.items())
        + f"; flat range_search {1e3 * range_s:.4g} ms; adc recall@{MAIN_K} {adc_figs['recall']}, "
        f"rerank512 B={ADC_BATCH} {adc_times['search rerank512'][1]:.1f} QPS, pq_train "
        f"{adc_figs['train_s']:.2f} s, pq_encode {adc_figs['encode_s']:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
