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
        brute force (>= 0.85 and >= 0.90). The coarse term and the allow
        mask are K9/K10's epilogue: the filtered search may write no
        [B, nprobe * probe_cap] tensor but the kernel's output and the
        top-C sort.
  ADC:  bench.py's bench_adc: PQ8x8 (pq_train 15 iters on 131,072 rows,
        pq_encode) of a 1,000,000 x 128 lowdim corpus; at B=256 the ADC-only
        top-10 and the exact f32 rerank of the ADC top-128 and top-512 (K8);
        range_scan_adc(strategy="auto") at B=64 with a radius from the data
        (K6); adc_scan_u4 over a pq16x4 encoding at B=64 (K7). Ids against
        the same calls through the plain versions, range ids and counts
        against a mask over K6's plain output, recall@10 against brute
        force (>= 0.95 after rerank512).

  IVF-PQ host tier: the pq16 index above with host_rerank=True: batch_search
        at B=8 (K10) and B=256 (K9), serve_session().search and
        batch_search_stream over 8 batches; the device view holds no
        vectors; ids equal the device tier's at the same C (rerank_c=512) up
        to ties, distances within ops/rerank.host_rerank_dist_tol.
  hostpq: bench.py's bench_hostpq at its defaults: 10,000,000 x 96 clustered
        unit rows (bench/synth.clustered_corpus's recipe drawn on the card
        from a seeded torch.Generator), a trained quantizer (nlist=4096,
        minibatch k-means on 524,288 rows, 40 iterations), CSR metadata with
        no vectors, residual pq16 (10 iterations on 131,072 rows); a
        HostRerankSession over a CSRReader of the f32 corpus in host RAM
        (the native rerank) at B=64, nprobe=8, rerank_c=1024, k=10,
        lookahead 6: per-call search, the stream of 16 batches and 4 recall
        batches launch K9 once a batch, rerank natively every batch, and the
        stream equals search; the same session through the plain versions
        gives equal bits; the numpy rerank the same ids; recall@10 >= 0.95
        against exact f32 brute force over all rows; device bytes a row
        <= 64. Build seconds by stage, per-call ms, pipelined QPS, the
        candidate stage (events), the ids' copy to the host, the native
        rerank and the host CPU are printed.

  HNSW: bench.py's bench_hnsw: HNSWIndex over lowdim_corpus(100,000, 128,
        dz=16, seed=41) at HNSWConfig() defaults (m=16, ef_construction=200,
        ef_search=64) on the card: build (timed), batch_search at B=256 (4
        batches, recall@10 >= 0.97 against brute force) and B=8, a warm
        device_search at B=256 under torch.cuda.set_sync_debug_mode("error")
        (no host synchronisation) with its launches and device busy time
        from torch.profiler, batch_search_stream over 8 batches equal to
        batch_search, allow_ids over 10% of the ids (every result allowed,
        recall >= 0.95 over the allowed rows) and over 50 (the exact scan:
        brute force up to ties), 1% removed (none returned, recall >= 0.97);
        then 20,000 x 32 integer-valued rows built on the card and on the
        host at L2, IP (graphs equal field by field, search ids equal) and
        cosine (recall within 0.02). HNSW has no hand-written kernel.
  k-means: IVFIndex.optimize's Lloyd (k-means|| seeding, nlist=1024) over
        262,144 x 128 rows and pq_train (pq16) over 131,072 x 96, each
        trained twice from one seed on the card: equal bits.
  bench (phase_bench, last): the port's benchmark CLI,
        vectorindex_tpu_torch.bench.__main__.main, in this process: the
        flat, IVF (nlist=1024, nprobe=32) and IVF-PQ (pq16) suites over
        datagen.generate's 1,000,000 x 128 unit f32 rows, 256 queries in one
        batch (K1/K2 on the f32 FMA design, K4, K9 launched; every
        BenchResult field present and finite; flat recall 1.0 under the tie
        rule against an independent brute force, the harness's truth equal
        to it up to ties; K1/K2 held bit for bit to their plain versions on
        the suite's own f32 index and timed; the IVF and IVF-PQ suites'
        indices searched again through K4 / K9 and through their plain
        versions: equal results); the nprobe=8,32 sweep over
        generate_clustered's rows (recall does not fall as nprobe rises);
        the microbench at B=256 over 20 query slices beside its byte bound;
        and `python -m vectorindex_tpu_torch.bench` with no --device in a
        subprocess (131,072 rows, 64 queries, --vb): exit 0, its envelope
        names the card. JSON lands in build/bench/.

  wide flat: a bf16 FlatIndex at d = 3,072 (capacity 2^17, 120,000 rows):
        batch_search at B=8 and 64 through K1/K2 on the tensor cores
        (scan_fused.scan_design "wgmma", the query block's k chunk in each
        stage), recall@10 = 1.0, no strict fallback; K1/K2 held to their
        plain versions and to the FMA design (the CUDA cores, their route
        before) and timed in turns with it.

  f32 wide (phase_flat_f32_wide): 2^20 x 768 f32 rows (3.2 GB, drawn on the
        card from a seed) through scan_topk_fused at B=256 and B=8: K1/K2 on
        the FMA design (each row streamed in k chunks), every query exact,
        recall@10 = 1.0 under the tie rule against a chunked f32 brute force,
        K1/K2 equal to their first design bit for bit and to their plain
        versions by the parity rule (cuBLAS sums a d = 768 product in another
        order), timed in turns with the first design beside their bounds.

  4k wide (phase_flat_wide_full): 2^20 x 4,096 bf16 rows (8.6 GB, drawn on
        the card from a seed) through scan_topk_fused at B = 8, 64, 128 and
        256: K1/K2 on the wgmma design, every query exact, recall@10 = 1.0
        under the tie rule against a row-chunked f64 brute force, K1 <-> K2
        bit for bit and both within the parity rule of their plain versions
        and of the FMA design, timed by events and profiler device time in
        turns with the FMA design, beside their plain versions, cuBLAS's
        bf16 q x^T alone and their bound; at B = 128 and 256 the route's
        wide tile also in turns with the narrow tile's plan (plan_turns), whose
        floats it equals bit for bit.

  band (phase_flat_band): 2^20 x 384 bf16 rows (0.8 GB, drawn on the card
        from a seed; the band 128 < d <= 448 between the register-resident
        and the streamed query block) through scan_topk_fused at B = 128
        and 256: K1/K2 on the wgmma design, every query exact, recall@10 =
        1.0 under the tie rule against a row-chunked f64 brute force; K1/K2
        within the parity rule of their plain versions and of the first
        tensor-core design, K1 <-> K2 bit for bit, the route's wide tile bit
        for bit with the narrow tile's plan and timed in turns with it and with
        the first design, beside their plain versions, cuBLAS's bf16 q x^T
        and their bound. The MIPS index (d = 256, phase_api_flat) takes the
        same turns at B=256.

  f32 past 7,264 (phase_flat_f32_xwide): 2^17 x 8,192 f32 rows through
        scan_topk_fused at B=8: K1/K2 on the FMA design (past the first FMA
        design's width), every query exact, recall@10 = 1.0, within the
        parity rule of the plain versions, K1 <-> K2 bit for bit, timed.

  api (phase_api_*): a bf16 FlatIndex of 131,072 x 8,192 rows (capacity
        2^17) at B=8 and 64 through K1/K2 on the wgmma design (no strict
        fallback, recall@10 = 1.0 against f64 brute force; K1/K2 held to
        their plain versions and the FMA design and timed; scan_topk_fused,
        scan_topk_verified and scan_topk_strict timed on the same tensors);
        the verified route (ops/scan.scan_topk_verified) on the same index
        at k = 2C + 1 = 513, B=64, and on a manhattan f32 FlatIndex over
        the flat main path's 1M x 128 rows at B=8 and 64: telemetry names
        the path models/flat selects by B x capacity (scan_verified from
        VERIFIED_MIN_BLOCK = 2^22 on), no K1/K2 launch, no strict fallback,
        recall@k = 1.0 against f64 brute force, the verified and the strict
        selection timed on the same tensors (events and host clock), the
        verified call's peak memory under its bound; MIPS: the main rows augmented explicitly to
        padded_dim(128) = 256 in a bf16 L2 FlatIndex (K1/K2 at d = 256,
        held to their plain versions and timed), ids equal to an
        inner-product FlatIndex's up to ties, mips_hybrid_score_block equal
        to mips_virtual_to_l2_scores bit for bit; the acceleration seam on
        the flat 1M, IVF 1M and HNSW 100k indices: get_index_structure,
        get_batch_candidates at B=8 rescored in f64 on the card,
        finalize_results equal to batch_search (IVF: and to the exact
        search of the probed lists) up to ties.
  sharded (phase_sharded_*; one process, a mesh of devices, no
        torch.distributed): ShardedFlatIndex over the main rows on the
        visible cards and on 4 shards of cuda:0 (equal bits, ids equal to
        the unsharded index's up to ties at B=8 and 256, the time split
        into the shards' scoring and top-k and the gather and merge);
        partition_store of the IVF index over 4 shards and
        sharded_ivf_search (ids equal to the probed-list search);
        sharded_ivf_pq_search over pq16 (recall@10 >= 0.85 at nprobe 32);
        ShardedHNSWIndex over the HNSW rows on 4 shards (recall@10 >= 0.97
        at efS 64, save / load_index equal, 500 tail inserts without a
        rebuild and 1% removed: recall over the live rows >= 0.97).

  persist: each main-path index, before it is freed, saved into a temporary
        directory (removed at the end) and restored on the card: the flat
        1M x 128 bf16 index by save_container / load_container (bf16 kept; B=8
        and B=256 through K1/K2 equal to the live index bit for bit, no strict
        fallback); the IVF index through enable_durable, 1,000 journaled
        inserts, 100 removes, 100 vector and 100 metadata updates,
        close_durable with no checkpoint (a crash) and load_durable (count,
        ids, dtype; B=8 K3 and B=256 K4 equal), then a checkpoint (generation
        up by one) and load_index (equal again); pq16 and pq32x4 + spill
        through enable_durable / load_durable (codebooks' bits equal; B=8 K10
        and pq16's B=256 K9 equal; k distinct ids a row); HNSW by
        save_container / load_container (no build step, graph equal field by
        field, B=256 ids and distances equal). load_index returns each file's
        class. The restored indices' launches count on the kernels' lines;
        save, load and first-result seconds, file sizes and journaled
        mutations a second are printed beside the card.

On bf16 rows K1, K2 and K11 run the wgmma design (csrc scan_wgmma_kernel;
kernels/scan_fused.wgmma_plan): the kernel-vs-plain cases, the main path's
own tensors (phase_times), the A/B path (phase_tree) and the MIPS index
also hold them to the first tensor-core design (bin_candidates_mma_v1,
count_below_mma_v1, bin_candidates_tree_v1) by the tensor-core rule and
time them in turns with it by CUDA events and the profiler's device time;
the kernels line carries cuBLAS's bf16 q x^T time (the product alone, not
their function) as a yardstick. scan_fused.DESIGN_LAUNCHES must show the
wgmma design on the flat, MIPS, accel and restored-flat paths, with every
first design's count at 0, and no wgmma-design kernel may spill.

Wherever K1/K2 run on the FMA design (the f32 kernel-vs-plain cases, the
bench CLI's f32 index, the f32 rows at d = 768) they are also held bit for
bit to their first design (kernels/scan_fused
bin_candidates_fma_v1, count_below_fma_v1), which never runs on a main path,
and timed in turns with it by CUDA events and the profiler's device time;
the bench CLI's flat batch wall is split once into K1, K2, other device time
and host. After the build, every FMA-design kernel's registers are printed
and a kernel with local memory (a spill) fails the run.

The flat path also runs FlatIndex.range_search on its index (a few queries,
one filtered), checked against brute force. K6 and K7 are also timed in
their first designs (kernels/adc.adc_scan_u8_v1, adc_scan_u4_v1), and K8
(csrc/adc_topk.cu) in its second (kernels/adc.adc_topk_fused_v2, queries on
the lanes one a lane), in turns with the shipping ones, by CUDA events and
the profiler's device time, beside the write-only floor of K6/K7's output;
K8's second and first designs are held to the plain version bit for bit on
every ADC case and the main path, and a K8 kernel with local memory fails
the run. The range call at B=64 is split into K6 and its mask + sort; so are K3, K4
and K5 (kernels/ivf_probe.ivf_probe_topc_v1 and ivf_probe_scores_v1) on the
IVF path's own tensors, and K9/K10 (kernels/adc_probe.adc_probe_scores_v1)
on the IVF-PQ path's; the first designs are checked against the plain
versions there but never run on a main path. K9/K10 are also held to their
plain versions with and without their epilogue (base, allow) over a skewed
store at B = 1, 8, 16, 17 and 256 (u8 m=16, u8 m=8, packed u4 m=32; starts
shifted off the 16-row units), and under every launch plan the A/B sweeps.

It checks the kernels against their plain versions again on each main
path's own tensors, and times the kernels, their plain versions and the
end-to-end searches with CUDA events. It imports nothing of JAX.

Output: one line per phase, the card's name and power limit (from
nvidia-smi), a JSON line describing each kernel (K6-K10 with their lookup
floor: the f32 shared-memory lookups over 132 SMs x 128 B a clock at the SM
clock nvidia-smi reads under K8), and last the line
{"ok": true, "device": {...}}. Any failed check raises, exiting non-zero;
without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
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
#: the pq16 index's host-rerank tier (IVFPQConfig(host_rerank=True) through
#: dataclasses.replace): batch_search at B=8 (K10) and B=256 (K9),
#: serve_session().search and batch_search_stream over PQ_HOST_BATCHES
#: batches of B=8, against the device tier at the same C
PQ_HOST_BATCHES = 8

#: host-rerank tier at capacity: bench.py's bench_hostpq defaults
#: (bench.py:1194-1290): bench/synth.clustered_corpus(10M, 96, nlist=4096,
#: seed=31, spread 0.15, unit rows), a trained quantizer (minibatch k-means on
#: 524,288 sampled rows, 40 iterations, chunked assignment), CSR metadata
#: with no vectors, residual pq16 (pq_train on 131,072 rows, 10 iterations);
#: B=64, nprobe=8, rerank_c=1024, k=10, lookahead 6; 256 evaluation queries
#: and 16 stream batches of bench.py's _noisy_queries at noise 0.05
HOSTPQ_ROWS, HOSTPQ_DIM, HOSTPQ_NLIST, HOSTPQ_SEED, HOSTPQ_SPREAD = 10_000_000, 96, 4096, 31, 0.15
HOSTPQ_KM_SAMPLE, HOSTPQ_KM_ITERS, HOSTPQ_KM_BATCH = 524_288, 40, 65_536
HOSTPQ_M, HOSTPQ_KS, HOSTPQ_PQ_SAMPLE, HOSTPQ_PQ_ITERS = 16, 256, 131_072, 10
HOSTPQ_BATCH, HOSTPQ_NPROBE, HOSTPQ_RERANK_C, HOSTPQ_LOOKAHEAD = 64, 8, 1024, 6
HOSTPQ_EVAL, HOSTPQ_STREAM, HOSTPQ_NOISE = 256, 16, 0.05
HOSTPQ_RECALL_MIN = 0.95  # the TPU bench's hostpq line reads 0.9766 (another quantizer)
HOSTPQ_DEVICE_BYTES_MAX = 64  # a device byte budget a row far under the f32 row's 384

#: HNSW main path: bench.py's bench_hnsw (bench.py:1409-1432): L2 over
#: lowdim_corpus(100,000, 128, dz=16, seed=41), HNSWConfig() defaults (m=16,
#: ef_construction=200, ef_search=64, build_chunk=1024, build_expand=8),
#: lowdim_queries(W, ...) at k=10: HNSW_BATCHES batches of B=256, B=8 calls,
#: a stream of HNSW_STREAM batches of 256 with lookahead 3
HNSW_ROWS, HNSW_DIM, HNSW_DZ, HNSW_SEED = 100_000, 128, 16, 41
HNSW_BATCH, HNSW_BATCHES, HNSW_SMALL_CALLS, HNSW_STREAM, HNSW_LOOKAHEAD = 256, 4, 16, 8, 3
HNSW_RECALL_MIN, HNSW_FILTER_RECALL_MIN = 0.97, 0.95  # the TPU bench's hnsw line reads 0.9938
#: allow_ids filters: 10% of the ids (the ef-scaled beam), 50 ids (the exact
#: scan); the share of ids removed before the tombstone search
HNSW_ALLOW_FRAC, HNSW_ALLOW_FEW, HNSW_REMOVE_FRAC = 0.10, 50, 0.01
#: the card against the host: integer-valued rows (every f32 product and sum
#: exact, every sort two-key), built on both devices at each metric
HNSW_INT_ROWS, HNSW_INT_DIM, HNSW_INT_QUERIES = 20_000, 32, 256
HNSW_INT_CONFIG = dict(m=8, ef_construction=48, build_chunk=256)
#: cosine normalises the rows, so its two builds are held to recall@10 within this
HNSW_INT_COSINE_GAP = 0.02
#: k-means replayed from its seed on the card: IVFIndex.optimize's Lloyd at
#: nlist=1024 over 262,144 x 128 rows, and pq_train (pq16, 10 iterations)
#: over 131,072 x 96 rows, each trained twice
KM_ROWS, KM_DIM, KM_NLIST, KM_PQ_ROWS, KM_PQ_DIM, KM_PQ_M, KM_PQ_ITERS = (
    262_144, 128, 1024, 131_072, 96, 16, 10)

#: K9/K10 kernel-vs-plain cases over the skewed IVF store: batches on both
#: sides of K10's B <= 16 and of the plans' probes a CTA, an 8-byte code
#: row (m=8) beside pq16 and pq32x4, starts shifted off the 16-row units
PQ_CASE_NPROBE, PQ_CASE_BATCHES, PQ_CASE_SHIFT = 16, (1, SMALL_BATCH, 16, 17, 256), 3
PQ_CASE_CONFIGS = {"pq16": (16, 256), "pq8": (8, 256), "pq32x4": (32, 16)}

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
#: K6/K7/K8 kernel-vs-plain cases: (m, ks) over a ragged row count, at
#: batches below, within and past one K8 query block
ADC_CASE_ROWS, ADC_CASES = 262_144 + 77, ((8, 256), (16, 256), (16, 16), (32, 16))
ADC_CASE_BATCHES = (1, SMALL_BATCH, 17, ADC_RANGE_BATCH)
ADC_KERNELS = ("adc_scan_u8", "adc_scan_u4", "adc_topk_fused")
#: flat range search on the flat main path's index: queries, matches each
FLAT_RANGE_QUERIES, FLAT_RANGE_HITS = 4, 50
#: wide flat rows: a bf16 index of capacity 2^17 at d = 3,072 (OpenAI
#: text-embedding-3-large), past the first tensor-core design's route, whose
#: K1/K2 run on the tensor cores (the query block's k chunk in each stage),
#: searched at B=8 and 64 (d = 8,192 is phase_api_verified_wide's)
FLAT_WIDE_DIM, FLAT_WIDE_ROWS, FLAT_WIDE_BATCHES, FLAT_WIDE_CAPACITY = 3072, 120_000, (8, 64), 1 << 17
#: f32 rows at an embedding width (BERT-base, all-mpnet-base-v2: 768), 2^20
#: of them (3.2 GB): K1/K2's FMA design streams each row in k chunks
FLAT_F32_WIDE_ROWS, FLAT_F32_WIDE_DIM, FLAT_F32_WIDE_BATCHES = 1 << 20, 768, (256, 8)
#: a full-size wide corpus: 2^20 bf16 rows at d = 4,096 (e5-mistral-7b-
#: instruct, NV-Embed-v2; 8.6 GB) drawn on the card, through
#: scan_topk_fused on the tensor cores at B = 8, 64 (one query block), 128
#: and 256 (two and four)
FLAT_4K_ROWS, FLAT_4K_DIM, FLAT_4K_BATCHES = 1 << 20, 4096, (8, 64, 128, 256)
#: the band between the register-resident and the streamed query block
#: (128 < d <= 448): 2^20 bf16 rows at d = 384 (all-MiniLM-L6-v2,
#: bge-small; 0.8 GB) drawn on the card, through scan_topk_fused at B = 128
#: and 256, past one query tile (the wide chunked tile)
FLAT_BAND_ROWS, FLAT_BAND_DIM, FLAT_BAND_BATCHES = 1 << 20, 384, (128, 256)
#: f32 rows past the first FMA design's width (d > 7,264): 2^17 x 8,192
#: (4.3 GB) through scan_topk_fused at B=8 on the FMA design
FLAT_F32_XWIDE_ROWS, FLAT_F32_XWIDE_DIM, FLAT_F32_XWIDE_BATCH = 1 << 17, 8192, 8

#: the H100 SXM's published peaks (NVIDIA's data sheet): bytes/s of HBM3,
#: bf16 tensor-core and f32 CUDA-core FLOP/s
HBM_BYTES_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
#: f32 adds a second: F32_FLOPS counts an FMA as two flops, and an FADD takes
#: a whole FMA slot (the ADC kernels K6-K10 add, they do not multiply)
F32_ADDS = F32_FLOPS / 2
#: its SMs, and the bytes one SM's shared memory delivers a clock (32 banks
#: of 4 B; the Hopper architecture white paper)
H100_SMS, SMEM_BYTES_PER_CLOCK = 132, 128

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
    "adc_topk_fused": "vectorindex_tpu_torch/kernels/csrc/adc_topk.cu",
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
#: the first designs' launch counters (kernels/scan_fused), kept for timing:
#: 0 on every main path
FIRST_DESIGNS = ("bin_candidates_mma_v1", "count_below_mma_v1", "bin_candidates_tree_v1",
                 "bin_candidates_fma_v1", "count_below_fma_v1")


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


def narrow_plan(sf, nq: int, n: int, d: int, kernel: str):
    """The narrow tile's plan of the wgmma design at (nq, d), through wgmma_plan's hand
    arguments: two ring tiles a chunked stage at one query tile past the
    resident widths, at most two query tiles a CTA below them (cosine K1's
    query block in shared memory there)."""
    if sf.wgmma_plan(1, n, d).chunked:
        return sf.wgmma_plan(nq, n, d, kernel=kernel, chunk_tiles=sf.WG_CHUNK_TILES)
    return sf.wgmma_plan(nq, n, d, kernel=kernel, qt=min(2, -(-nq // 64)),
                         chunk_tiles=sf.WG_CHUNK_TILES)


def plan_turns(sf, qk, x, bias, cs, tau, metric, iters: int, calls: int,
               required: bool = True):
    """K1 and K2 (bf16 rows, the wgmma design) under the route's plan and
    under the narrow tile's (narrow_plan), where the two differ (past one query tile:
    the wide tile): first K1's candidates and K2's counts held equal bit for
    bit, then both timed in turns (turns(); the narrow tile's under the "_v1" keys) ->
    the figures and both plans, or None where the plans are one."""
    nq, n, d = qk.shape[0], x.shape[0], x.shape[1]
    names = ("bin_candidates", "count_below")
    route = {k: sf.wgmma_plan(nq, n, d, kernel=k) for k in names}
    old = {k: narrow_plan(sf, nq, n, d, k) for k in names}
    if route == old:
        return None
    kd, ki = sf._wgmma_launch("bin_candidates", qk, x, bias, cs, metric, plan=route["bin_candidates"])
    od, oi = sf._wgmma_launch("bin_candidates", qk, x, bias, cs, metric, plan=old["bin_candidates"])
    lt, le = sf._wgmma_launch("count_below", qk, x, bias, cs, metric, tau, plan=route["count_below"])
    olt, ole = sf._wgmma_launch("count_below", qk, x, bias, cs, metric, tau, plan=old["count_below"])
    torch.cuda.synchronize()
    require(torch.equal(kd, od) and torch.equal(ki, oi),
            f"B={nq} d={d}: K1's wide tile is not the narrow tile's plan bit for bit")
    require(torch.equal(lt, olt) and torch.equal(le, ole),
            f"B={nq} d={d}: K2's wide tile is not the narrow tile's plan bit for bit")
    launch = {k: (lambda p, k=k: (lambda: sf._wgmma_launch(
        k, qk, x, bias, cs, metric, tau if k == "count_below" else None, plan=p))) for k in names}
    t = turns({k: (launch[k](route[k]), launch[k](old[k])) for k in names}, iters, calls, required)
    out = {}
    for k in names:
        out[k] = t[k]
        out[k + "_dev"] = t[k + "_dev"]
        out[k + "_narrow"] = t[k + "_v1"]
        out[k + "_narrow_dev"] = t[k + "_v1_dev"]
        out[k + "_rounds"] = t[k + "_rounds"]
        out[k + "_narrow_rounds"] = t[k + "_v1_rounds"]
        out[k + "_plan"] = route[k]._asdict()
        out[k + "_narrow_plan"] = old[k]._asdict()
    return out


def plan_log(t) -> str:
    if t is None:
        return "the route's plan is the narrow tile's"
    return "; ".join(
        f"{k} wide tile {t[k]:.4g} ms (device {dev_str(t[k + '_dev'])}) against the narrow tile's plan "
        f"{t[k + '_narrow']:.4g} ms (device {dev_str(t[k + '_narrow_dev'])}; rounds "
        f"{rounds_str(t[k + '_rounds'])} / {rounds_str(t[k + '_narrow_rounds'])}), bit for bit"
        for k in ("bin_candidates", "count_below"))


def narrow_fields(t, name: str) -> dict:
    """The kernels line's figures of the narrow tile's plan in turns with the route's
    (plan_turns), where the two differ."""
    if not t:
        return {}
    return {"wide_tile_ms": t[name], "wide_tile_device_ms": t[name + "_dev"],
            "narrow_plan_ms": t[name + "_narrow"], "narrow_plan_device_ms": t[name + "_narrow_dev"],
            "narrow_plan": t[name + "_narrow_plan"]}


def earlier_design(sf, d: int, dtype):
    """The design K1/K2 ran on these rows before the one scan_design gives
    now, kept for timing (the suffix of its wrappers): on bf16 the first
    tensor-core design up to d = 2,400 (its route) and the FMA design past
    it (the route of wider bf16 rows before the tensor cores took every
    width); on f32 the first FMA design up to FMA_MAX_D (its query block's
    limit), and None past it."""
    if dtype == torch.bfloat16:
        return "mma_v1" if d <= 2400 else "fma"
    return "fma_v1" if d <= sf.FMA_MAX_D else None


def check_against_plain(sf, topk, qk, x, bias, cs, metric, kk=MAIN_K, exact=None):
    """K1 and K2 against their plain versions on the same inputs on the card.

    f32 corpora: both sides sum each dot product as one f32 FMA chain over d
    in order (the FMA design's fma_chunk; cuBLAS's f32 GEMM with TF32 off for
    the plain versions), so they agree bit for bit; on the FMA design K1 and
    K2 also equal their first design (the _v1 wrappers) bit for bit. bf16
    corpora: the kernels sum on the tensor cores (the wgmma design, in
    another order than cuBLAS); on integer-valued data (exact=True) every
    partial sum is exact and they agree bit for bit; otherwise the
    tensor-core rule holds (check_candidates, check_counts) and K1 <-> K2
    bit identity is checked on its own (check_identity). The wgmma design is
    also held to the earlier design of these rows (earlier_design: the first
    tensor-core design, or past d = 2,400 the FMA design on the CUDA cores,
    one f32 chain in k order) by the same rule. f32 rows past the first FMA
    design's width have no earlier design to hold them to. Returns (K1
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
    earlier = earlier_design(sf, x.shape[1], x.dtype)
    if earlier == "fma_v1":
        # the FMA design computes its first design's floats: equal bit for bit
        vd, vi = sf.bin_candidates_fma_v1(qk, x, bias, cs, metric=metric)
        vlt, vle = sf.count_below_fma_v1(qk, x, bias, cs, tau, metric=metric)
        torch.cuda.synchronize()
        require(torch.equal(kd, vd) and torch.equal(ki, vi),
                "K1: the FMA design differs from its first design")
        require(torch.equal(klt, vlt) and torch.equal(kle, vle),
                "K2: the FMA design's counts differ from its first design's")
    elif earlier is not None:
        # the earlier design sums in another order: the tensor-core rule
        # against it (bit for bit where every sum is exact)
        vd, vi = getattr(sf, "bin_candidates_" + earlier)(qk, x, bias, cs, metric=metric)
        vlt, vle = getattr(sf, "count_below_" + earlier)(qk, x, bias, cs, tau, metric=metric)
        torch.cuda.synchronize()
        check_candidates(f"K1 against its earlier design ({earlier})", kd, ki, vd, vi, qk, x,
                         bias, cs, metric, exact)
        diff = torch.maximum((klt - vlt).abs(), (kle - vle).abs())
        if exact:
            require(int(diff.max()) == 0,
                    f"K2: the wgmma design's counts differ from the earlier design's ({earlier})")
        else:
            from vectorindex_tpu_torch.utils import parity

            near = parity.count_near(qk, x, bias, cs, tau, metric)
            require(bool((diff <= 2 * near).all()),
                    f"K2: the wgmma design's counts differ from the earlier design's ({earlier}) "
                    "by more than the rows near tau")
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
                vd, vi = sf.bin_candidates_tree_v1(q, x_pad, bias, metric=metric, tile=tile)
                torch.cuda.synchronize()
                rd, ri = sf.bin_candidates_tree_ref(q, x_pad, bias, metric=metric, tile=tile)
                check_candidates("K11", kd, ki, rd, ri, q, x_pad, bias, None, metric, True)
                check_candidates("K11 against its first design", kd, ki, vd, vi, q, x_pad, bias,
                                 None, metric, True)
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
    """Squared-L2 distances to every row in x_dev's dtype (f32, or f64 for
    wide rows), stable sort -> (distances [B, N], true k-th distance [B],
    top-k ids [B, k])."""
    qd = torch.from_numpy(q).to(x_dev.device, x_dev.dtype)
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
    require(sf.DESIGN_LAUNCHES["wgmma"] == launches and not any(
        sf.LAUNCHES[name] for name in FIRST_DESIGNS), f"main: K1/K2 not on the wgmma design alone: "
        f"{sf.DESIGN_LAUNCHES}, {sf.LAUNCHES}")
    TELEM.disable()
    counters = TELEM.snapshot()["counters"]
    fallback = counters.get("flat.verify_fallback", 0)
    log(f"main: {len(batches)} batches through K1+K2, launches {launches} (wgmma design; first "
        f"designs {dict((n, sf.LAUNCHES[n]) for n in FIRST_DESIGNS)}), strict fallback for "
        f"{fallback} of {nq} queries")
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
    """Check K1 and K2 against their plain versions and their first
    tensor-core design on the main path's own tensors and queries (B=256
    and B=8, so both plans; errs takes the larger errors), then time them in
    turns with the first design (events and profiler device time)."""
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
        t = design_turns(sf, qk, x, bias, cs, tau, Metric.L2, 10, 5)
        t["narrow"] = plan_turns(sf, qk, x, bias, cs, tau, Metric.L2, 10, 5)
        t["bin_candidates_plain"] = time_ms(lambda: sf.bin_candidates_ref(*args, metric=Metric.L2), 3)
        t["count_below_plain"] = time_ms(lambda: sf.count_below_ref(*args, tau, metric=Metric.L2), 3)
        idx.batch_search(batch, MAIN_K)  # warm
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            idx.batch_search(batch, MAIN_K)
            lat.append(time.perf_counter() - t0)
        t["search_ms_median"] = 1e3 * float(np.median(lat))
        t["qps"] = b / float(np.median(lat))
        times[b] = t
        log(f"times B={b} n={x.shape[0]} d={x.shape[1]} bf16 L2 (wgmma design, first design "
            f"in turns): {design_log(t)}; plan {t['bin_candidates_plan']}; {plan_log(t['narrow'])}; "
            + ", ".join(
                f"{key}={val:.4g}" for key, val in t.items() if key.endswith("_plain")
                or key in ("search_ms_median", "qps")))
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
    require(launches == len(TREE_TILES) and not sf.LAUNCHES["bin_candidates_tree_v1"],
            f"K11 did not run on its path alone: {sf.LAUNCHES}")
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
        vd, vi = sf.bin_candidates_tree_v1(qk, x, bias, metric=Metric.L2, tile=tile)
        torch.cuda.synchronize()
        check_candidates("K11 against its first design", kd, ki, vd, vi, qk, x, bias, None,
                         Metric.L2, False)
        tt = turns({"tree": (
            lambda: sf.bin_candidates_tree(qk, x, bias, metric=Metric.L2, tile=tile),
            lambda: sf.bin_candidates_tree_v1(qk, x, bias, metric=Metric.L2, tile=tile))}, 10, 5)
        t[tile] = {
            "ms": tt["tree"], "device_ms": tt["tree_dev"], "first_design_ms": tt["tree_v1"],
            "first_design_device_ms": tt["tree_v1_dev"],
            "plain_ms": time_ms(lambda: sf.bin_candidates_tree_ref(qk, x, bias, metric=Metric.L2,
                                                                    tile=tile), 3),
            "flagged": int((~exact).sum()),
        }
        log(f"tree tile={tile} B={b}: K11 within the tensor-core tolerance of its plain version "
            f"and its first design (max_abs_err {err:.3g} at the same rows); flags "
            f"{t[tile]['flagged']}/{b} queries (K1+K2: {int((~fex).sum())}); ids equal "
            f"scan_topk_fused's on the {int(both.sum())} queries exact in both; kernel "
            f"{t[tile]['ms']:.4g} ms (device {t[tile]['device_ms']:.4g}; rounds "
            f"{[round(v, 4) for v in tt['tree_rounds']]}), first design "
            f"{t[tile]['first_design_ms']:.4g} ms (device {t[tile]['first_design_device_ms']:.4g}; "
            f"rounds {[round(v, 4) for v in tt['tree_v1_rounds']]}), plain "
            f"{t[tile]['plain_ms']:.4g} ms")
    qb = qk.to(torch.bfloat16)
    t["matmul_ms"] = time_ms(lambda: torch.matmul(qb, x.T), 10)
    t["matmul_device_ms"] = device_ms(lambda: torch.matmul(qb, x.T), 5)
    log(f"tree: cuBLAS bf16 q x^T [{b}, {x.shape[0]}] (the product alone, bf16 out; not K1's "
        f"function) {t['matmul_ms']:.4g} ms (device {t['matmul_device_ms']:.4g}); path launches "
        f"{{'bin_candidates_tree': {launches}}}")
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
    from vectorindex_tpu_torch.bench.synth import lowdim_corpus, lowdim_queries
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
    (nprobe=32) against their plain versions, their first designs against
    the same, then the times of both designs in turns, the plain versions'
    times, the bounds and the end-to-end batch_search latency."""
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
    cases = (
        ("ivf_probe_topc", kp.ivf_probe_topc_rankmajor, kp.ivf_probe_topc_rankmajor_ref,
         kp.ivf_probe_topc_v1, {}, args8),
        ("ivf_probe_scores_rankmajor", kp.ivf_probe_scores_rankmajor,
         kp.ivf_probe_scores_rankmajor_ref, kp.ivf_probe_scores_v1, {"deny_sentinel": True}, args8),
        ("ivf_probe_scores", kp.ivf_probe_scores, kp.ivf_probe_scores_ref, kp.ivf_probe_scores_v1,
         {}, args256),
    )
    for name, _, ref, v1, extra, args in cases:  # the first designs compute the same bits
        got, want = v1(*args, **extra, **kw), ref(*args, **kw)
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        require(all(torch.equal(a, r) for a, r in pairs),
                f"{name}: the first design differs from the plain version")
    log("ivf main-shape check: the first designs of K3, K5 and K4 equal the plain versions too")
    for name, fn, ref, v1, extra, args in cases:
        # the redesign and its first design in turns (new, old, old, new) on one card
        runs = {"new": [], "v1": []}
        for design in ("new", "v1", "v1", "new"):
            call = fn if design == "new" else functools.partial(v1, **extra)
            runs[design].append(time_ms(lambda: call(*args, **kw), 50))
        t[name], t[name + "_v1"] = (float(np.mean(r)) for r in runs.values())
        t[name + "_plain"] = time_ms(lambda: ref(*args, **kw), 3, warmup=1)
        t[name + "_bound"] = probe_bound(kp, args[0], args[1], args[2], arrays, cap, name)
        log(f"ivf times {name} B={len(args[0])} nprobe={IVF_NPROBE} in turns (new, old, old, "
            f"new): kernel {runs['new']} ms, first design {runs['v1']} ms; plain "
            f"{t[name + '_plain']:.4g} ms, bound {t[name + '_bound'][0]:.4g} ms "
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


def check_adc_kernels(ap, args, kw, what, base=None, allow=None):
    """K9 and K10 against their plain versions on the same inputs, without
    and with the epilogue (base, allow): equal bit for bit (both add the m
    LUT entries in order from 0, each add rounded, then the row correction,
    then base). Returns max_abs_err per kernel."""
    errs = dict.fromkeys(PQ_KERNELS, 0.0)
    epilogues = [{}] if base is None else [{}, dict(base=base, row_allow=allow)]
    for extra in epilogues:
        ref = ap.adc_probe_scores_ref(*args, **kw, **extra)
        for name in PQ_KERNELS:
            got = getattr(ap, name)(*args, **kw, **extra)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], max_abs_err(got, ref))
            require(torch.equal(got, ref), f"{name}: {what}{' with base and allow' if extra else ''} "
                    "differs from the plain version")
    return errs


def check_adc_plans(ap, args, kw, base, allow, what):
    """The K9/K10 kernel under every launch plan the A/B sweeps (1, 2, 4
    or 8 probes a CTA) equals the plain version bit for bit."""
    nprobe = args[1].shape[1]
    ref = ap.adc_probe_scores_ref(*args, **kw, base=base, row_allow=allow)
    plans = [g for g in (1, 2, 4, 8) if g <= nprobe]
    for g in plans:
        got = ap._launch("adc_probe_scores", *args, kw["probe_cap"], kw["m"], kw["ks"],
                         kw["packed_u4"], base, allow, probes=g)
        torch.cuda.synchronize()
        require(torch.equal(got, ref), f"K9 at G={g}: {what} differs from the plain version")
    return len(plans)


def phase_pq_compare(ap):
    """Random codes, row corrections and query LUTs over the skewed store
    (empty lists, one of 12,000 rows: probe_cap 16,384), u8 m=16 ks=256, u8
    m=8 (8-byte rows) and packed u4 m=32 ks=16, L2 and IP LUTs, B = 1, 8,
    16, 17 and 256, starts as stored and shifted by PQ_CASE_SHIFT rows,
    without and with the epilogue (a coarse term, its rows strided, and a
    10% allow mask); every launch plan on two of the cases."""
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.utils.config import Metric

    errs = dict.fromkeys(PQ_KERNELS, 0.0)
    arrays, cap, centers, n = skewed_store(PQ_DIM, torch.float32, PQ_DIM)
    require(cap >= 4096, f"probe_cap {cap} < 4096")
    n_rows = arrays.row_ids.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    allow = torch.rand(n_rows, generator=gen, device=DEVICE) < 0.1
    for name, (m, ks) in PQ_CASE_CONFIGS.items():
        codes = torch.randint(0, ks, (n_rows, m), generator=gen, device=DEVICE).to(torch.uint8)
        if ks <= 16:
            codes = pq.pack_u4(codes)
        books = pq.books_from_centroids(
            torch.randn(m, ks, PQ_DIM // m, generator=gen, device=DEVICE))
        for metric, lut_fn in ((Metric.L2, pq.pq_lut_q_l2), (Metric.INNER_PRODUCT, pq.pq_lut_ip)):
            tcorr = torch.randn(n_rows, generator=gen, device=DEVICE)
            if metric == Metric.INNER_PRODUCT:
                tcorr = torch.zeros_like(tcorr)
            for b in PQ_CASE_BATCHES:
                q = torch.randn(b, PQ_DIM, generator=gen, device=DEVICE)
                starts, lives = probe_tables(q, centers, arrays, PQ_CASE_NPROBE, metric)
                # rows strided, as the search's slice of ivf_select's sort is
                base = torch.randn(b, 2 * PQ_CASE_NPROBE, generator=gen,
                                   device=DEVICE)[:, :PQ_CASE_NPROBE]
                kw = dict(nprobe=PQ_CASE_NPROBE, probe_cap=cap, m=m, ks=ks, packed_u4=ks <= 16)
                lut = lut_fn(q, books).contiguous()
                for shift in (0, PQ_CASE_SHIFT):
                    args = (lut, (starts + shift).contiguous(),
                            torch.clamp(lives - shift, min=0).contiguous(), codes, tcorr)
                    for k, e in check_adc_kernels(ap, args, kw, f"a synthetic case (B={b}, shift "
                                                  f"{shift})", base, allow).items():
                        errs[k] = max(errs[k], e)
                    if name == "pq16" and metric == Metric.L2 and b in (SMALL_BATCH, 256) and shift:
                        plans = check_adc_plans(ap, args, kw, base, allow, f"B={b}")
                        log(f"pq compare {name} B={b}: {plans} launch plans equal the plain "
                            "version bit for bit")
            log(f"pq compare {name} (m={m} ks={ks}) {metric.value}: rows={n} cap={cap} "
                f"B={PQ_CASE_BATCHES}, starts shifted by 0 and {PQ_CASE_SHIFT}, without and with "
                "base and allow: K9 and K10 equal their plain versions bit for bit")
    return errs


def big_ops(fn, numel: int) -> set:
    """Names of the aten operators fn() dispatches with an output of
    exactly numel elements (a kernel launched through ctypes is none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if any(isinstance(o, torch.Tensor) and o.numel() == numel for o in outs):
                seen.add(func.overloadpacket.__name__)
            return out

    with Record():
        fn()
    return seen


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
    if name == "pq16":
        # the coarse term and the allow mask are the kernel's epilogue: no
        # operator of the filtered search writes a [B, nprobe * probe_cap]
        # tensor but the kernel's output (empty) and the top-C sort
        from vectorindex_tpu_torch.ops import ivf as tivf

        slots = SMALL_BATCH * PQ_NPROBE * tivf.probe_cap_for(idx._store.max_length)
        ops = big_ops(lambda: idx.batch_search(batches[0], MAIN_K, allow_ids=allow_ids), slots)
        require(ops <= {"empty", "sort"}, f"{name}: the filtered search made extra passes: {ops}")
        log(f"{name}: filtered B={SMALL_BATCH}: the only operators over its {slots} probed slots "
            f"are {sorted(ops)} (no separate base add or allow mask)")

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
    return bound(nbytes, (m + 1) * float(lives.sum()), F32_ADDS)


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
        require(torch.equal(ap.adc_probe_scores_v1(*args, **kw), ref(*args, **kw)),
                f"{kname}: the first design differs from the plain version")
        # the new design and the first design in turns (new, old, old, new) on one card
        runs = {"new": [], "v1": []}
        for design in ("new", "v1", "v1", "new"):
            call = fn if design == "new" else ap.adc_probe_scores_v1
            runs[design].append(time_ms(lambda: call(*args, **kw), 50))
        t[kname], t[kname + "_v1"] = (float(np.mean(r)) for r in runs.values())
        t[kname + "_dev"] = device_ms(lambda: fn(*args, **kw), 20, "adc_probe")
        t[kname + "_v1_dev"] = device_ms(lambda: ap.adc_probe_scores_v1(*args, **kw), 20, "adc_probe")
        t[kname + "_plain"] = time_ms(lambda: ref(*args, **kw), 3, warmup=1)
        t[kname + "_bound"] = adc_bound(args, cap, m, ks <= 16)
        t[kname + "_lookups"] = m * float(args[2].sum())
        log(f"{name} times {kname} B={args[0].shape[0]} nprobe={PQ_NPROBE} cap={cap} "
            f"(G={ap.probe_plan(args[0].shape[0], PQ_NPROBE, cap, m, ks, ks <= 16)}) in turns "
            f"(new, old, old, new): kernel {runs['new']} ms, first design {runs['v1']} ms; device "
            f"{t[kname + '_dev']:.5g} ms, first design {t[kname + '_v1_dev']:.5g} ms; plain "
            f"{t[kname + '_plain']:.4g} ms, bound {t[kname + '_bound'][0]:.4g} ms "
            f"({t[kname + '_bound'][1]})")
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


def same_host_results(got, want, k, what, tol):
    """Host-tier rows against device-tier rows: ids equal up to ties of the
    device tier's distances, squared scores within `tol` (the host rerank's
    f32 sums run in another order than the device's)."""
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    gi = np.array([[r.id for r in row] for row in got])
    wi = np.array([[r.id for r in row] for row in want])
    gd = np.array([[r.score for r in row] for row in got], dtype=np.float64) ** 2
    wd = np.array([[r.score for r in row] for row in want], dtype=np.float64) ** 2
    require(gi.shape == (len(got), k) and wi.shape == gi.shape, f"{what}: expected {k} results per query")
    require(np.abs(gd - wd).max() <= tol, f"{what}: distances differ by {np.abs(gd - wd).max()} > {tol}")
    require(ids_match_up_to_ties(gi, wi, wd, k), f"{what}: ids differ from the device tier's")
    return int((gi == wi).all(axis=1).sum())


def phase_pq_host_tier(ap, idx, evalq, bigq):
    """The pq16 index's host-rerank tier (the index's own entry points):
    the device tier's results first, then with host_rerank=True
    batch_search at B=8 (K10) and B=256 (K9), serve_session().search and
    batch_search_stream over PQ_HOST_BATCHES batches, the launch and rerank
    counts set to 0 just before and read just after. The host tier's rows
    (from the store's packed host mirror) must equal the device tier's at
    the same C up to ties, distances within host_rerank_dist_tol."""
    from vectorindex_tpu_torch.ops import rerank as rr

    batches = [evalq[i * SMALL_BATCH : (i + 1) * SMALL_BATCH] for i in range(PQ_HOST_BATCHES)]
    device_cfg = idx.config
    want = [idx.batch_search(b, MAIN_K) for b in batches]
    want_big = idx.batch_search(bigq, MAIN_K)
    idx.config = dataclasses.replace(device_cfg, host_rerank=True)
    ap.reset_launches()
    rr.reset_rerank_counts()
    walls = {"B=8": [], f"B={PQ_BIG_BATCH}": []}
    got = []
    for b in batches:
        t0 = time.perf_counter()
        got.append(idx.batch_search(b, MAIN_K))
        walls["B=8"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    got_big = idx.batch_search(bigq, MAIN_K)
    walls[f"B={PQ_BIG_BATCH}"].append(time.perf_counter() - t0)
    sess = idx.serve_session(lookahead=3)
    _, sess_ids = sess.search(batches[0], MAIN_K)
    streamed = list(idx.batch_search_stream(batches, MAIN_K, lookahead=3))
    launches, impl = dict(ap.LAUNCHES), dict(rr.RERANK_IMPL)
    n_small = 2 * PQ_HOST_BATCHES + 1
    require(launches == {"adc_probe_scores": 1, "adc_probe_scores_rankseg": n_small,
                         "adc_probe_scores_v1": 0},
            f"pq16 host tier: launches {launches}, expected K9 once and K10 {n_small} times")
    # the index's reader is its packed host mirror, keyed by CSR row: numpy
    require(impl == {"native": 0, "numpy": n_small + 1, "device": 0},
            f"pq16 host tier: rerank paths {impl}")
    arrays, _, _ = idx._sync_pq()
    require(arrays.vecs is None and arrays.sqnorms is None and sess.arrays.vecs is None,
            "pq16 host tier: the device view holds vectors")
    q_all = np.concatenate([evalq[: PQ_HOST_BATCHES * SMALL_BATCH], bigq])
    tol = rr.host_rerank_dist_tol(PQ_DIM, float((q_all * q_all).sum(1).max()) + 1.0)  # unit rows
    exact = sum(same_host_results(g, w, MAIN_K, f"pq16 host tier B=8 #{i}", tol)
                for i, (g, w) in enumerate(zip(got, want)))
    exact_big = same_host_results(got_big, want_big, MAIN_K, f"pq16 host tier B={PQ_BIG_BATCH}", tol)
    for i, (s_rows, g) in enumerate(zip(streamed, got)):
        require([[r.id for r in row] for row in s_rows] == [[r.id for r in row] for row in g],
                f"pq16 host tier: stream batch {i} differs from batch_search")
    require(sess_ids.tolist() == [[idx._idmap.lookup(r.id) for r in row] for row in got[0]],
            "pq16 host tier: serve_session().search differs from batch_search")
    idx.config = device_cfg
    med = {key: 1e3 * float(np.median(v)) for key, v in walls.items()}
    log(f"pq16 host tier (host_rerank=True, rerank_c={PQ_RERANK_C}): launches {launches}, rerank "
        f"paths {impl}; device view vecs None; ids equal the device tier's up to ties "
        f"({exact}/{PQ_HOST_BATCHES * SMALL_BATCH} B=8 rows and {exact_big}/{PQ_BIG_BATCH} B="
        f"{PQ_BIG_BATCH} rows exactly), distances within {tol:.3g}; stream of {PQ_HOST_BATCHES} "
        f"and serve_session equal batch_search; walls B=8 median {med['B=8']:.4g} ms, B="
        f"{PQ_BIG_BATCH} {med[f'B={PQ_BIG_BATCH}']:.4g} ms")
    return launches, med


def phase_pq(ap, ps, api):
    """Both IVF-PQ configurations over one corpus → (errors, launches summed
    over both main-path runs, pq16's host tier's launches, times, build and
    recall figures); pq16 is also searched sharded (phase_sharded_pq)."""
    from vectorindex_tpu_torch.bench.synth import lowdim_corpus, lowdim_queries

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
            launches[k] = launches.get(k, 0) + c
        if name == "pq16":
            tier_launches, builds[name]["host_tier_ms"] = phase_pq_host_tier(ap, idx, evalq[:PQ_EVAL],
                                                                             evalq)
        times[name] = phase_pq_times(ap, name, idx, batches, evalq, pool, errs)
        if name == "pq16":
            with api.timed("sharded pq16"):
                phase_sharded_pq(idx, evalq[:PQ_EVAL], truth, api)
        phase_persist_pq(ap, name, idx, batches, evalq, ps)
        del idx
        torch.cuda.empty_cache()
    return errs, launches, tier_launches, times, builds


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


def wide_index(dim: int, rows: int, nq: int, seed: int):
    """A bf16 L2 FlatIndex of capacity FLAT_WIDE_CAPACITY holding `rows`
    seeded gaussian rows of width dim (bf16 values), nq held-out queries
    (bf16 values too, so no path's rounding of q changes them), and the rows
    on the card as f64 for brute force."""
    from vectorindex_tpu_torch.models.flat import FlatIndex
    from vectorindex_tpu_torch.utils.config import Metric

    x, queries = make_data(rows, dim, nq, seed)
    idx = FlatIndex(dim, Metric.L2, capacity=FLAT_WIDE_CAPACITY, storage_dtype=torch.bfloat16,
                    device=DEVICE)
    idx.insert_batch(list(range(rows)), x)
    # f64: an f32 brute force over thousands of terms errs by more than
    # RECALL_RTOL; the index's own f32 sums err far less than the gaps
    x_dev = torch.from_numpy(x).to(DEVICE).double()
    return idx, queries, x_dev


def search_counted(sf, idx, q: np.ndarray):
    """batch_search with the launch and telemetry counts set to 0 just
    before and read just after -> (results, K1/K2 launches by design,
    telemetry counters)."""
    from vectorindex_tpu_torch.utils.telemetry import TELEM

    TELEM.reset()
    TELEM.enable()
    sf.reset_launches()
    try:
        res = idx.batch_search(q, MAIN_K)
    finally:
        TELEM.disable()
    designs = {d: dict(c) for d, c in sf.DESIGN_LAUNCHES.items()}
    return res, designs, TELEM.snapshot()["counters"]


def phase_flat_wide(sf, topk):
    """Wide bf16 rows: FlatIndex at d = FLAT_WIDE_DIM, capacity 2^17
    (FLAT_WIDE_ROWS live rows: dead slots keep the mask path live),
    batch_search at B=8 and 64 through K1/K2 on the wgmma design, no strict
    fallback, recall@10 = 1.0; K1 and K2 against their plain versions and
    the FMA design (the CUDA cores, their earlier route) on the index's
    tensors (the utils/parity rule; K1 <-> K2 bit identity on its own) and
    timed at B=64 in turns with the FMA design."""
    from vectorindex_tpu_torch.utils.config import Metric

    t0 = time.perf_counter()
    nq = sum(FLAT_WIDE_BATCHES)
    idx, queries, x_dev = wide_index(FLAT_WIDE_DIM, FLAT_WIDE_ROWS, nq, SEED + 3)
    log(f"wide: bf16 FlatIndex {FLAT_WIDE_ROWS}x{FLAT_WIDE_DIM}, capacity {idx.capacity}, built "
        f"in {time.perf_counter() - t0:.2f} s; scan_design -> "
        f"{sf.scan_design(FLAT_WIDE_DIM, torch.bfloat16)}")
    sq_dev = (x_dev * x_dev).sum(dim=1)
    launches, t = {"bin_candidates": 0, "count_below": 0}, {}
    start = 0
    for b in FLAT_WIDE_BATCHES:
        q = queries[start : start + b]
        start += b
        res, designs, counters = search_counted(sf, idx, q)
        require(designs["fma"] == {"bin_candidates": 0, "count_below": 0}
                and all(c > 0 for c in designs["wgmma"].values()),
                f"wide B={b}: K1/K2 did not run on the wgmma design: {designs}")
        require(counters.get("flat.verify_fallback", 0) == 0 and "kernel.scan_strict.calls" not in counters,
                f"wide B={b}: a query fell back to the strict path")
        for name, c in designs["wgmma"].items():
            launches[name] += c
        dist, kth, truth = brute_force(x_dev, sq_dev, q, MAIN_K)
        r_tie, r_set = recall(res, dist, kth, truth, MAIN_K)
        log(f"wide: B={b} K1/K2 launches by design {designs}, recall@{MAIN_K}={r_tie} "
            f"(set recall {r_set}), no strict fallback")
        require(r_tie == 1.0, f"wide B={b}: recall@{MAIN_K} {r_tie} < 1")
        idx.batch_search(q, MAIN_K)  # warm
        lat = []
        for _ in range(5):
            t1 = time.perf_counter()
            idx.batch_search(q, MAIN_K)
            lat.append(time.perf_counter() - t1)
        t[f"search B={b}"] = 1e3 * float(np.median(lat))
    del dist, x_dev, sq_dev

    x, sqn, _, valid = idx._sync_device()
    qk, bias, cs, _ = sf.kernel_inputs(torch.from_numpy(queries[-FLAT_WIDE_BATCHES[-1]:]).to(DEVICE),
                                       sqn, valid, Metric.L2)
    errs = {"bin_candidates": 0.0, "count_below": 0}
    t.update(wide_figures(sf, topk, qk, x, bias, cs, errs, "wide", 6, 3))
    t["launches"] = launches
    log("wide: search " + ", ".join(f"{key} {val:.4g} ms" for key, val in t.items()
                                    if key.startswith("search")))
    del idx, x, sqn, valid, qk, bias
    torch.cuda.empty_cache()
    return launches, t, errs


def wide_figures(sf, topk, qk, x, bias, cs, errs, label: str, iters: int, calls: int,
                 plain_iters: int = 3) -> dict:
    """K1 and K2 on wide L2 rows, in the design scan_design gives them: held
    to their plain versions by the parity rule (K1 <-> K2 bit identity on
    its own; errs takes the larger errors) and to their earlier design
    (earlier_design), timed in turns with it (design_turns: events and
    profiler device time), beside their plain versions, cuBLAS's q x^T in
    the corpus dtype alone (not K1's function: a yardstick), their bound
    and the f32 pipe's floor (which bounds any CUDA-core design)."""
    from vectorindex_tpu_torch.utils.config import Metric

    m = Metric.L2
    n, d = x.shape
    k1, k2, tau = check_against_plain(sf, topk, qk, x, bias, cs, m, exact=False)
    errs["bin_candidates"] = max(errs["bin_candidates"], k1)
    errs["count_below"] = max(errs["count_below"], k2)
    args = (qk, x, bias, cs)
    if earlier_design(sf, d, x.dtype) is not None:
        t = design_turns(sf, qk, x, bias, cs, tau, m, iters, calls, required=False)
    else:  # no earlier design at this width: the kernels alone
        t = {"earlier": None}
        for name, fn in (("bin_candidates", lambda: sf.bin_candidates(*args, metric=m)),
                         ("count_below", lambda: sf.count_below(*args, tau, metric=m))):
            t[name] = time_ms(fn, iters)
            t[name + "_dev"] = device_ms(fn, calls, required=False)
            plan = (sf.wgmma_plan(qk.shape[0], n, d, kernel=name) if x.dtype == torch.bfloat16
                    else sf.fma_plan(qk.shape[0], n, d, x.dtype, name))
            t[name + "_plan"] = {"design": sf.scan_design(d, x.dtype), **plan._asdict()}
    t["narrow"] = (plan_turns(sf, qk, x, bias, cs, tau, m, iters, calls, required=False)
                 if x.dtype == torch.bfloat16 else None)
    t["bin_candidates_plain"] = time_ms(lambda: sf.bin_candidates_ref(*args, metric=m), plain_iters, 1)
    t["count_below_plain"] = time_ms(lambda: sf.count_below_ref(*args, tau, metric=m), plain_iters, 1)
    qb = qk.to(x.dtype)
    t["cublas_product_ms"] = time_ms(lambda: torch.matmul(qb, x.T), iters)
    item = x.element_size()
    for name in ("bin_candidates", "count_below"):
        t[name + "_bound"] = flat_bound(n, d, qk.shape[0], item, name)
        t[name + "_f32_pipe"] = flat_bound(n, d, qk.shape[0], item, name, F32_FLOPS)[0]
    t["max_abs_err"] = k1
    t["count_diff"] = k2
    earlier = (f"; {design_log(t)}" if t["earlier"] else "; " + "; ".join(
        f"{name} {t[name]:.4g} ms (device {dev_str(t[name + '_dev'])}), no earlier design at this width"
        for name in ("bin_candidates", "count_below")))
    log(f"{label}: K1/K2 ({sf.scan_design(d, x.dtype)} design, B={qk.shape[0]}, n={n}, d={d} "
        f"{str(x.dtype).split('.')[-1]}) within the parity rule of their plain versions (K1 "
        f"max_abs_err {k1:.3g}, K2 count diff {k2}), K1 <-> K2 bit for bit"
        + (f", and of their earlier design ({t['earlier']})" if t["earlier"] else "")
        + f"{earlier}; {plan_log(t['narrow'])}; plain {t['bin_candidates_plain']:.4g} / "
        f"{t['count_below_plain']:.4g} ms; "
        f"cuBLAS q x^T alone {t['cublas_product_ms']:.4g} ms; bound "
        f"{t['bin_candidates_bound'][0]:.4g} / "
        f"{t['count_below_bound'][0]:.4g} ms ({t['bin_candidates_bound'][1]}), the f32 pipe's floor "
        f"{t['bin_candidates_f32_pipe']:.4g} ms")
    return t


def phase_flat_f32_wide(sf, topk, errs) -> dict:
    """f32 rows at an embedding width (FLAT_F32_WIDE_ROWS x FLAT_F32_WIDE_DIM,
    3.2 GB, drawn on the card from a seed; queries near some rows) through
    scan_topk_fused at B=256 and B=8: K1/K2 on the FMA design (k chunks of
    each row in the ring), every query proved exact (no strict fallback),
    recall@10 = 1.0 under the tie rule against a chunked f32 brute force on
    the card; K1/K2 equal to their first design bit for bit and to their
    plain versions by the parity rule (cuBLAS's d = 768 product sums in
    another order), and timed in turns with the first design beside their
    bounds."""
    from vectorindex_tpu_torch.utils.config import Metric

    t_phase = time.perf_counter()
    n, d = FLAT_F32_WIDE_ROWS, FLAT_F32_WIDE_DIM
    require(sf.scan_design(d, torch.float32) == "fma", "f32 wide: not on the FMA design")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + d)
    x = torch.randn(n, d, generator=gen, device=DEVICE)
    nq = sum(FLAT_F32_WIDE_BATCHES)
    pick = torch.randint(0, n, (nq,), generator=gen, device=DEVICE)
    queries = (x[pick] + 0.1 * torch.randn(nq, d, generator=gen, device=DEVICE)).cpu().numpy()
    xp, sqp, vp = sf.pad_corpus(x, None, None)
    out, start = {}, 0
    for b in FLAT_F32_WIDE_BATCHES:
        q = queries[start : start + b]
        start += b
        qd = torch.from_numpy(q).to(DEVICE)
        sf.reset_launches()
        dist, ids, exact = sf.scan_topk_fused(qd, xp, sqp, vp, metric=Metric.L2, k=MAIN_K)
        torch.cuda.synchronize()
        designs = {k: dict(c) for k, c in sf.DESIGN_LAUNCHES.items()}
        require(designs["wgmma"] == {"bin_candidates": 0, "count_below": 0}
                and all(c > 0 for c in designs["fma"].values()),
                f"f32 wide B={b}: K1/K2 did not run on the FMA design: {designs}")
        require(bool(exact.all()), f"f32 wide B={b}: {int((~exact).sum())} queries need the strict path")
        truth, kth = chunked_truth(x, q, MAIN_K, chunk=1 << 18)
        xg = x[ids.long()]  # [b, k, d]: the returned rows' distances in f32
        d_got = (xg * xg).sum(dim=2) - 2.0 * (xg @ qd[:, :, None])[..., 0] + (qd * qd).sum(dim=1, keepdim=True)
        hits = d_got <= kth[:, None] + RECALL_RTOL * kth.abs()[:, None]
        r_tie = float(hits.float().mean())
        r_set = float((ids.long()[:, :, None] == truth[:, None, :]).any(dim=2).float().mean())
        require(r_tie == 1.0, f"f32 wide B={b}: recall@{MAIN_K} {r_tie} < 1 under the tie rule")
        qk, bias, cs, _ = sf.kernel_inputs(qd, sqp, vp, Metric.L2)
        # cuBLAS sums a d = 768 product in another order than one k-order
        # FMA chain: the plain versions by the parity rule, the first design
        # bit for bit
        k1, k2, tau = check_against_plain(sf, topk, qk, xp, bias, cs, Metric.L2, exact=False)
        errs["bin_candidates"] = max(errs["bin_candidates"], k1)
        errs["count_below"] = max(errs["count_below"], k2)
        args = (qk, xp, bias, cs)
        t = design_turns(sf, qk, xp, bias, cs, tau, Metric.L2, 5, 3)
        t["bin_candidates_plain"] = time_ms(lambda: sf.bin_candidates_ref(*args, metric=Metric.L2), 2, 1)
        t["count_below_plain"] = time_ms(lambda: sf.count_below_ref(*args, tau, metric=Metric.L2), 2, 1)
        for name in ("bin_candidates", "count_below"):
            t[name + "_bound"] = flat_bound(n, d, b, 4, name)
        t["launches"] = designs["fma"]
        log(f"f32 wide: {n}x{d} f32, B={b} through scan_topk_fused: K1/K2 launches by design "
            f"{designs}, every query exact, recall@{MAIN_K}={r_tie} under the tie rule (set recall "
            f"{r_set}); K1/K2 equal to their first design bit for bit, within the parity rule of "
            f"their plain versions (K1 max_abs_err {k1:.3g}, K2 count diff {k2}); "
            f"{design_log(t)}; plain {t['bin_candidates_plain']:.4g} / {t['count_below_plain']:.4g} ms; "
            f"bound {t['bin_candidates_bound'][0]:.4g} / {t['count_below_bound'][0]:.4g} ms "
            f"({t['bin_candidates_bound'][1]})")
        out[b] = t
    del x, xp, sqp, vp
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"f32 wide: phase {out['phase_s']:.1f} s")
    return out


def chunked_truth64(x, q: torch.Tensor, k: int, chunk: int = 1 << 16):
    """Exact f64 brute force over the rows of x (any dtype; converted a row
    chunk at a time, never whole) for queries q [B, d] -> (ids [B, k],
    k-th distance [B])."""
    q64 = q.double()
    qn = (q64 * q64).sum(dim=1, keepdim=True)
    best_d = torch.full((q.shape[0], 0), float("inf"), dtype=torch.float64, device=x.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.long, device=x.device)
    for s in range(0, x.shape[0], chunk):
        xc = x[s : s + chunk].double()
        dist = (xc * xc).sum(dim=1)[None, :] - 2.0 * (q64 @ xc.T) + qn
        cd, ci = torch.topk(dist, k, dim=1, largest=False, sorted=True)
        md, sel = torch.sort(torch.cat([best_d, cd], dim=1), dim=1, stable=True)
        best_d = md[:, :k]
        best_i = torch.gather(torch.cat([best_i, ci + s], dim=1), 1, sel[:, :k])
        del xc, dist
    return best_i, best_d[:, k - 1]


def fused_recall64(x, q: torch.Tensor, ids, k: int):
    """(tie-aware recall@k, set recall) of scan_topk_fused's ids [B, k]
    against chunked_truth64: a returned row whose exact f64 distance is at
    most the true k-th (within RECALL_RTOL) is a hit."""
    truth, kth = chunked_truth64(x, q, k)
    q64 = q.double()
    xg = x[ids.long()].double()  # [B, k, d]
    d_got = ((xg - q64[:, None, :]) ** 2).sum(dim=2)
    hits = d_got <= kth[:, None] + RECALL_RTOL * kth.abs()[:, None]
    same = (ids.long()[:, :, None] == truth[:, None, :]).any(dim=2)
    return float(hits.float().mean()), float(same.float().mean())


def fused_counted(sf, q, xp, sqp, vp, design: str, what: str):
    """scan_topk_fused with the launch counts set to 0 just before and read
    just after: K1/K2 launched on `design` alone, every query proved exact
    (no strict fallback) -> (ids, K1/K2 launches on the design)."""
    from vectorindex_tpu_torch.utils.config import Metric

    sf.reset_launches()
    _, ids, exact = sf.scan_topk_fused(q, xp, sqp, vp, metric=Metric.L2, k=MAIN_K)
    torch.cuda.synchronize()
    designs = {k: dict(c) for k, c in sf.DESIGN_LAUNCHES.items()}
    other = "fma" if design == "wgmma" else "wgmma"
    require(designs[other] == {"bin_candidates": 0, "count_below": 0}
            and all(c > 0 for c in designs[design].values()),
            f"{what}: K1/K2 did not run on the {design} design: {designs}")
    require(bool(exact.all()), f"{what}: {int((~exact).sum())} queries need the strict path")
    return ids, designs[design]


def phase_flat_wide_full(sf, topk, errs) -> dict:
    """The full-size wide corpus: FLAT_4K_ROWS x FLAT_4K_DIM bf16 rows drawn
    on the card from a seed (queries near some rows, rounded to bf16),
    through scan_topk_fused at each of FLAT_4K_BATCHES: K1/K2 on the wgmma
    design, every query proved exact (no strict fallback), recall@10 = 1.0
    under the tie rule against a row-chunked f64 brute force; K1/K2 held to
    their plain versions and the FMA design by the parity rule, K1 <-> K2
    bit for bit, timed in turns with the FMA design beside their plain
    versions, cuBLAS's bf16 q x^T and their bound (wide_figures)."""
    from vectorindex_tpu_torch.utils.config import Metric

    t_phase = time.perf_counter()
    n, d = FLAT_4K_ROWS, FLAT_4K_DIM
    require(sf.scan_design(d, torch.bfloat16) == "wgmma", "4k wide: not on the wgmma design")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + d)
    x = torch.empty((n, d), dtype=torch.bfloat16, device=DEVICE)
    sq = torch.empty(n, device=DEVICE)
    for s in range(0, n, 1 << 17):  # in slices: no f32 copy of the corpus
        xs = torch.randn((min(1 << 17, n - s), d), generator=gen, device=DEVICE).bfloat16()
        x[s : s + len(xs)] = xs
        xf = xs.float()
        sq[s : s + len(xs)] = (xf * xf).sum(dim=1)
    del xs, xf
    nq = sum(FLAT_4K_BATCHES)
    pick = torch.randint(0, n, (nq,), generator=gen, device=DEVICE)
    queries = (x[pick].float() + 0.1 * torch.randn((nq, d), generator=gen, device=DEVICE)
               ).bfloat16().float()
    xp, sqp, vp = sf.pad_corpus(x, sq, None)
    log(f"4k wide: {n} x {d} bf16 ({n * d * 2 / 1e9:.2f} GB) drawn on the card in "
        f"{time.perf_counter() - t_phase:.1f} s; scan_design -> {sf.scan_design(d, torch.bfloat16)}")
    out, start = {"launches": {"bin_candidates": 0, "count_below": 0}}, 0
    for b in FLAT_4K_BATCHES:
        q = queries[start : start + b].contiguous()
        start += b
        ids, launched = fused_counted(sf, q, xp, sqp, vp, "wgmma", f"4k wide B={b}")
        for name, c in launched.items():
            out["launches"][name] += c
        r_tie, r_set = fused_recall64(x, q, ids, MAIN_K)
        require(r_tie == 1.0, f"4k wide B={b}: recall@{MAIN_K} {r_tie} < 1 under the tie rule")
        log(f"4k wide: B={b} through scan_topk_fused: K1/K2 launches on the wgmma design "
            f"{launched}, every query exact, recall@{MAIN_K}={r_tie} under the tie rule against "
            f"f64 brute force (set recall {r_set})")
        qk, bias, cs, _ = sf.kernel_inputs(q, sqp, vp, Metric.L2)
        t = wide_figures(sf, topk, qk, xp, bias, cs, errs, f"4k wide B={b}", 4, 2, 2)
        t["launches"] = launched
        t["recall"] = r_tie
        out[b] = t
    del x, xp, sqp, vp, sq, queries
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"4k wide: phase {out['phase_s']:.1f} s")
    return out


def phase_flat_band(sf, topk, errs) -> dict:
    """The band's corpus: FLAT_BAND_ROWS x FLAT_BAND_DIM bf16 rows drawn on
    the card from a seed (queries near some rows, rounded to bf16), through
    scan_topk_fused at each of FLAT_BAND_BATCHES: K1/K2 on the wgmma design,
    every query proved exact (no strict fallback), recall@10 = 1.0 under the
    tie rule against a row-chunked f64 brute force; then wide_figures: K1/K2
    held to their plain versions by the parity rule and K1 <-> K2 bit for
    bit, K1 and K2 on the route's wide tile bit for bit with the narrow
    tile's plan, timed in turns with it and with the first tensor-core
    design, beside their plain versions, cuBLAS's bf16 q x^T and their
    bound."""
    from vectorindex_tpu_torch.utils.config import Metric

    t_phase = time.perf_counter()
    n, d = FLAT_BAND_ROWS, FLAT_BAND_DIM
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + d)
    x = torch.empty((n, d), dtype=torch.bfloat16, device=DEVICE)
    sq = torch.empty(n, device=DEVICE)
    for s in range(0, n, 1 << 18):
        xs = torch.randn((min(1 << 18, n - s), d), generator=gen, device=DEVICE).bfloat16()
        x[s : s + len(xs)] = xs
        xf = xs.float()
        sq[s : s + len(xs)] = (xf * xf).sum(dim=1)
    del xs, xf
    nq = sum(FLAT_BAND_BATCHES)
    pick = torch.randint(0, n, (nq,), generator=gen, device=DEVICE)
    queries = (x[pick].float() + 0.1 * torch.randn((nq, d), generator=gen, device=DEVICE)
               ).bfloat16().float()
    xp, sqp, vp = sf.pad_corpus(x, sq, None)
    log(f"band: {n} x {d} bf16 ({n * d * 2 / 1e9:.2f} GB) drawn on the card in "
        f"{time.perf_counter() - t_phase:.1f} s")
    out, start = {"launches": {"bin_candidates": 0, "count_below": 0}}, 0
    for b in FLAT_BAND_BATCHES:
        q = queries[start : start + b].contiguous()
        start += b
        ids, launched = fused_counted(sf, q, xp, sqp, vp, "wgmma", f"band B={b}")
        for name, c in launched.items():
            out["launches"][name] += c
        r_tie, r_set = fused_recall64(x, q, ids, MAIN_K)
        require(r_tie == 1.0, f"band B={b}: recall@{MAIN_K} {r_tie} < 1 under the tie rule")
        log(f"band: B={b} through scan_topk_fused: K1/K2 launches on the wgmma design {launched}, "
            f"every query exact, recall@{MAIN_K}={r_tie} under the tie rule against f64 brute force "
            f"(set recall {r_set})")
        qk, bias, cs, _ = sf.kernel_inputs(q, sqp, vp, Metric.L2)
        t = wide_figures(sf, topk, qk, xp, bias, cs, errs, f"band B={b}", 10, 3, 2)
        require(t["narrow"] is not None, f"band B={b}: the route takes the narrow tile's plan")
        t["launches"] = launched
        t["recall"] = r_tie
        out[b] = t
    del x, xp, sqp, vp, sq, queries
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"band: phase {out['phase_s']:.1f} s")
    return out


def phase_flat_f32_xwide(sf, topk, errs) -> dict:
    """f32 rows past the first FMA design's width: FLAT_F32_XWIDE_ROWS x
    FLAT_F32_XWIDE_DIM drawn on the card (queries near some rows) through
    scan_topk_fused at B = FLAT_F32_XWIDE_BATCH: K1/K2 on the FMA design (k
    chunks of each row in the ring), every query proved exact, recall@10 =
    1.0 under the tie rule against f64 brute force; K1/K2 held to their
    plain versions by the parity rule, K1 <-> K2 bit for bit, timed beside
    their plain versions and their bound (no earlier design takes this
    width)."""
    from vectorindex_tpu_torch.utils.config import Metric

    t_phase = time.perf_counter()
    n, d, b = FLAT_F32_XWIDE_ROWS, FLAT_F32_XWIDE_DIM, FLAT_F32_XWIDE_BATCH
    require(sf.scan_design(d, torch.float32) == "fma", "f32 past 7,264: not on the FMA design")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + d + 1)
    x = torch.randn((n, d), generator=gen, device=DEVICE)
    pick = torch.randint(0, n, (b,), generator=gen, device=DEVICE)
    q = x[pick] + 0.1 * torch.randn((b, d), generator=gen, device=DEVICE)
    xp, sqp, vp = sf.pad_corpus(x, None, None)
    ids, launched = fused_counted(sf, q, xp, sqp, vp, "fma", f"f32 d={d} B={b}")
    r_tie, r_set = fused_recall64(x, q, ids, MAIN_K)
    require(r_tie == 1.0, f"f32 d={d} B={b}: recall@{MAIN_K} {r_tie} < 1 under the tie rule")
    log(f"f32 past 7,264: {n} x {d} f32, B={b} through scan_topk_fused: K1/K2 launches on the FMA "
        f"design {launched} (plan {sf.fma_plan(b, n, d, torch.float32, 'bin_candidates')}), every "
        f"query exact, recall@{MAIN_K}={r_tie} (set {r_set})")
    qk, bias, cs, _ = sf.kernel_inputs(q, sqp, vp, Metric.L2)
    t = wide_figures(sf, topk, qk, xp, bias, cs, errs, f"f32 d={d} B={b}", 6, 3)
    t["launches"] = launched
    t["recall"] = r_tie
    del x, xp, sqp, vp
    torch.cuda.empty_cache()
    t["phase_s"] = time.perf_counter() - t_phase
    log(f"f32 past 7,264: phase {t['phase_s']:.1f} s")
    return t


def device_ms(fn, calls: int, match: str = "", tries: int = 6, required: bool = True):
    """torch.profiler device time per call of fn() of the kernels whose
    names contain `match` ("" = every kernel and copy of the call). A
    profiling session that records no such kernel is repeated, up to
    `tries` sessions (three sessions in a row once recorded nothing for the
    bench suite's K1/K2 on the H100, late in a run); then a required time
    fails the run, another is None ("not recorded": the wide phases, whose
    events are the figure quoted, as the profiler read K1 low there)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and match in e.key)
        if total > 0:
            return total / 1e3 / calls
    if not required:
        log(f"profiler: no device time recorded for {match or 'the call'} in {tries} sessions")
        return None
    raise AssertionError(f"the profiler saw no device time for {match or 'the call'} "
                         f"in {tries} sessions")


# ---------------------------------------------------------------------------
# phase 10: the full-corpus ADC kernels against their plain versions
# ---------------------------------------------------------------------------


def turns(pairs: dict, iters: int, calls: int, required: bool = True) -> dict:
    """{name: (new, first)}: each pair of calls timed in two rounds of turns
    (new, first; then first, new) by CUDA events (mean of `iters` launches)
    and by the profiler's device time per call (`calls` launches; every
    kernel of the call, a split merge included; device_ms's `required`) ->
    {name: ms, name_dev: ms, name_v1: ms, name_v1_dev: ms} (means of the two
    rounds; a device time no round recorded is None) and each side's
    rounds."""
    out = {}
    for name, (new, old) in pairs.items():
        ev = {"": [], "_v1": []}
        dev = {"": [], "_v1": []}
        for order in (("", "_v1"), ("_v1", "")):
            for tag in order:
                fn = new if tag == "" else old
                ev[tag].append(time_ms(fn, iters))
                dev[tag].append(device_ms(fn, calls, required=required))
        for tag in ("", "_v1"):
            seen = [v for v in dev[tag] if v is not None]
            out[name + tag] = float(np.mean(ev[tag]))
            out[name + tag + "_dev"] = float(np.mean(seen)) if seen else None
            out[name + tag + "_rounds"] = ev[tag] + dev[tag]
    return out


def design_turns(sf, qk, x, bias, cs, tau, metric, iters: int, calls: int,
                 required: bool = True) -> dict:
    """K1 and K2 in the design scan_design gives these rows (wgmma, or FMA)
    and in the earlier design of these rows (earlier_design: the first
    tensor-core design, the FMA design on wide bf16 rows, or the first FMA
    design; its figures under the "_v1" keys, its name under "earlier"), on
    the same inputs, timed in turns (turns()) -> its figures and each
    kernel's plan."""
    design = sf.scan_design(x.shape[1], x.dtype)
    v1 = earlier_design(sf, x.shape[1], x.dtype)
    out = turns({
        "bin_candidates": (lambda: sf.bin_candidates(qk, x, bias, cs, metric=metric),
                           lambda: getattr(sf, "bin_candidates_" + v1)(qk, x, bias, cs,
                                                                        metric=metric)),
        "count_below": (lambda: sf.count_below(qk, x, bias, cs, tau, metric=metric),
                        lambda: getattr(sf, "count_below_" + v1)(qk, x, bias, cs, tau,
                                                                  metric=metric)),
    }, iters, calls, required)
    for name in ("bin_candidates", "count_below"):
        nq, n, d = qk.shape[0], x.shape[0], x.shape[1]
        plan = (sf.wgmma_plan(nq, n, d, kernel=name) if design == "wgmma"
                else sf.fma_plan(nq, n, d, x.dtype, name))
        out[name + "_plan"] = {"design": design, **plan._asdict()}
    out["earlier"] = v1
    return out


def design_shape(t: dict, name: str, bound_ms: tuple, launches=None) -> dict:
    """One shape's figures of kernel `name` (design_turns) for the kernels
    line."""
    fig = {"ms": t[name], "device_ms": t[name + "_dev"], "first_design_ms": t[name + "_v1"],
           "first_design_device_ms": t[name + "_v1_dev"], "earlier_design": t["earlier"],
           "plain_ms": t.get(name + "_plain"), "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
           "plan": t[name + "_plan"], **narrow_fields(t.get("narrow"), name)}
    if launches is not None:
        fig["launches"] = launches
    return fig


def dev_str(v) -> str:
    return "not recorded" if v is None else f"{v:.4g}"


def rounds_str(vals) -> list:
    return [None if v is None else round(v, 4) for v in vals]


def design_log(t: dict) -> str:
    return "; ".join(
        f"{name} {t[name]:.4g} ms (device {dev_str(t[name + '_dev'])}), earlier design "
        f"({t['earlier']}) {t[name + '_v1']:.4g} ms (device {dev_str(t[name + '_v1_dev'])}; rounds new "
        f"{rounds_str(t[name + '_rounds'])}, first {rounds_str(t[name + '_v1_rounds'])})"
        for name in ("bin_candidates", "count_below"))


def check_k8(fa, codes, lut, k, k6, errs, what):
    """K8 and its second design against the plain version (bit for bit)
    and K6 (K8's distances at its rows); returns K8's rows."""
    kd, ki = fa.adc_topk_fused(codes, lut, k)
    torch.cuda.synchronize()
    rd, ri = fa.adc_topk_fused_ref(codes, lut, k)
    errs["adc_topk_fused"] = max(errs["adc_topk_fused"], max_abs_err(kd, rd))
    require(torch.equal(kd, rd) and torch.equal(ki, ri), f"K8 {what}: differs from the plain version")
    require(torch.equal(kd, torch.gather(k6, 1, ki.long())) and bool((ki < codes.shape[0]).all()),
            f"K8 {what}: distances are not K6's at its rows")
    vd, vi = fa.adc_topk_fused_v2(codes, lut, k)
    require(torch.equal(vd, rd) and torch.equal(vi, ri),
            f"K8's second design {what}: differs from the plain version")
    return ki


def phase_adc_compare(fa):
    """Random codes and non-negative LUTs over ADC_CASE_ROWS rows (a ragged
    last tile, n % 4 != 0: K6/K7 write with plain stores), B in
    ADC_CASE_BATCHES (below, within and past one K8 query block): K6 and K8
    (k=10 and 512; and K8's second design) on u8 codes, K7 on packed u4, and
    K6/K7's first designs, against their plain versions; then K8 on a query
    whose three nearest rows share a class. Equal bit for bit (one add
    order: j ascending from 0, each add rounded); K8's distances equal K6's
    at K8's rows, K7's equal K6's on the unpacked codes."""
    from vectorindex_tpu_torch.ops import pq

    errs = dict.fromkeys(ADC_KERNELS, 0.0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    n = ADC_CASE_ROWS
    for m, ks in ADC_CASES:
        codes = torch.randint(0, ks, (n, m), generator=gen, device=DEVICE).to(torch.uint8)
        packed = pq.pack_u4(codes) if ks <= 16 else None
        for b in ADC_CASE_BATCHES:
            lut = torch.rand(b, m, ks, generator=gen, device=DEVICE)
            k6 = fa.adc_scan_u8(codes, lut)
            torch.cuda.synchronize()
            ref = fa.adc_scan_u8_ref(codes, lut)
            errs["adc_scan_u8"] = max(errs["adc_scan_u8"], max_abs_err(k6, ref))
            require(torch.equal(k6, ref), f"K6 m={m} ks={ks} B={b}: differs from the plain version")
            require(torch.equal(fa.adc_scan_u8_v1(codes, lut), ref),
                    f"K6's first design m={m} ks={ks} B={b}: differs from the plain version")
            if packed is not None:
                k7 = fa.adc_scan_u4(packed, lut)
                torch.cuda.synchronize()
                ref = fa.adc_scan_u4_ref(packed, lut)
                errs["adc_scan_u4"] = max(errs["adc_scan_u4"], max_abs_err(k7, ref))
                require(torch.equal(k7, ref) and torch.equal(k7, k6),
                        f"K7 m={m} B={b}: differs from its plain version or from K6")
                require(torch.equal(fa.adc_scan_u4_v1(packed, lut), ref),
                        f"K7's first design m={m} B={b}: differs from the plain version")
            for k in (MAIN_K, 2 * 256):
                check_k8(fa, codes, lut, k, k6, errs, f"m={m} ks={ks} B={b} k={k}")
        log(f"adc compare m={m} ks={ks} rows={n}: K6, K8 and its second design (k=10, 512)"
            + (" and K7 (packed u4)" if packed is not None else "")
            + f" and K6/K7's first designs at B={', '.join(map(str, ADC_CASE_BATCHES))} equal "
            "their plain versions bit for bit")
    # class crowding: query 5's three nearest rows c, c + 256, c + 512 share class c
    codes = torch.randint(0, 256, (n, 8), generator=gen, device=DEVICE).to(torch.uint8)
    lut = torch.rand(17, 8, 256, generator=gen, device=DEVICE) + 1.0
    c = 37
    codes[[c, c + 256, c + 512]] = lut[5].argmin(dim=1).to(torch.uint8)
    ki = check_k8(fa, codes, lut, MAIN_K, fa.adc_scan_u8(codes, lut), errs, "class crowding")
    require(ki[5, :3].tolist() == [c, c + 256, c + 512], "K8 lost a row of a crowded class")
    log("adc compare class crowding (B=17): K8 returns the 3 nearest rows of one class, "
        "equal to its plain version, as does its second design")
    return errs


# ---------------------------------------------------------------------------
# phase 11: the ADC main path
# ---------------------------------------------------------------------------


def adc_build():
    """bench_adc's corpus, PQ8x8 books and codes, the pq16x4 books and packed
    codes of the same corpus, and the f32 rows for the rerank → dict."""
    from vectorindex_tpu_torch.bench.synth import lowdim_corpus, lowdim_queries
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
    require(not any(launches[n] for n in launches if n not in ADC_KERNELS),
            f"an earlier K6/K7/K8 design ran on the main path: {launches}")

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
    return launches, {"recall": {c: r[0] for c, r in recalls.items()}}, (evalq, q64, lut64, lut4,
                                                                         radius)


def sm_clock_under(fn, seconds: float = 1.5) -> float:
    """The highest SM clock (MHz) that nvidia-smi reads every 100 ms while
    fn() runs back to back for about `seconds`."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    readings = [float(v) for v in out.split() if v.strip().isdigit()]
    require(readings, "nvidia-smi read no SM clock")
    return max(readings)


def lookup_floor_ms(lookups: float, sm_clock_mhz: float) -> float:
    """Least time for this many f32 lookups from shared memory: 4 B each
    over the H100's 132 SMs x 128 B a clock at the measured SM clock."""
    return 1e3 * lookups * 4.0 / (H100_SMS * SMEM_BYTES_PER_CLOCK * sm_clock_mhz * 1e6)


def adc_bounds(n: int, b: int, m: int, ks: int, mb: int, k: int = 0):
    """(bound_ms, bound_by) of K6/K7 (k=0: a [B, n] f32 output) or K8 (a
    [B, k] top-k): the codes and LUTs read once, the output written once;
    B * n * m f32 adds at F32_ADDS."""
    out = b * k * 8 if k else b * n * 4
    return bound(n * mb + b * m * ks * 4 + out, float(b) * n * m, F32_ADDS)


def phase_adc_times(fa, st, tensors, errs):
    """K6/K7 at B=64 and K8 at B=256 on the main path's tensors: each, in
    every design, against its plain version; K6/K7 timed in turns with their
    first designs and K8 with its second (queries on the lanes, one a lane),
    by events and by the profiler; bounds and the write-only floor; the
    range call's split into K6 and compaction; K6 + a stable top-10 of its
    [256, 1M] output as K8's scan-then-select yardstick; embedding_bag as
    K6's library call; then the median wall of the B=256 searches."""
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.ops.topk import topk

    evalq, q64, lut64, lut4, radius = tensors
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
        require(torch.equal(getattr(fa, fn + "_v1")(*args), ref),
                f"{name}'s first design differs from the plain version (main path)")
        errs[name] = max(errs[name], max_abs_err(got, ref))
        del got, ref
    errs["adc_topk_fused"] = max(errs["adc_topk_fused"], max_abs_err(k8[0], ref8[0]))
    for design in ("v2", "v1"):
        got = getattr(fa, "adc_topk_fused_" + design)(codes, lut256, MAIN_K)
        require(torch.equal(got[0], ref8[0]) and torch.equal(got[1], ref8[1]),
                f"K8's {design} design differs from the plain version (B=256)")
    require(fa.k8_route(ADC_M, ADC_KS, ADC_BATCH) == "ring", "K8 routes the main shape away")
    log("adc main-shape check: K6, K7 (B=64) and K8 (B=256), each in every design, equal their "
        "plain versions bit for bit")
    del k6_256, ref8, got
    cases = (  # (kernel, plain version, bound, lookups)
        ("adc_scan_u8", lambda: fa.adc_scan_u8_ref(codes, lut64),
         adc_bounds(n, ADC_RANGE_BATCH, ADC_M, ADC_KS, ADC_M), ADC_RANGE_BATCH * n * ADC_M),
        ("adc_scan_u4", lambda: fa.adc_scan_u4_ref(packed, lut4),
         adc_bounds(n, ADC_RANGE_BATCH, ADC_U4_M, ADC_U4_KS, ADC_U4_M // 2),
         ADC_RANGE_BATCH * n * ADC_U4_M),
        ("adc_topk_fused", lambda: fa.adc_topk_fused_ref(codes, lut256, MAIN_K),
         adc_bounds(n, ADC_BATCH, ADC_M, ADC_KS, ADC_M, MAIN_K), ADC_BATCH * n * ADC_M),
    )
    # each kernel and its earlier design in turns (new, old, old, new) by
    # CUDA events, then by the profiler's device time per call (new, old,
    # old, new): K6/K7 against their first designs, K8 against its second
    designs = {
        "adc_scan_u8": (lambda: fa.adc_scan_u8(codes, lut64), lambda: fa.adc_scan_u8_v1(codes, lut64),
                        "adc_qlane_scan_kernel", "adc_scan_kernel", "first"),
        "adc_scan_u4": (lambda: fa.adc_scan_u4(packed, lut4), lambda: fa.adc_scan_u4_v1(packed, lut4),
                        "adc_qlane_scan_kernel", "adc_scan_kernel", "first"),
        "adc_topk_fused": (lambda: fa.adc_topk_fused(codes, lut256, MAIN_K),
                           lambda: fa.adc_topk_fused_v2(codes, lut256, MAIN_K),
                           "adc_ring_candidates_kernel", "adc_qlane_candidates_kernel", "second"),
    }
    for name, (new, old, new_k, old_k, which) in designs.items():
        runs = {"new": [], "old": []}
        dev = {"new": [], "old": []}
        for design in ("new", "old", "old", "new"):
            runs[design].append(time_ms(new if design == "new" else old, 20))
        for design in ("new", "old", "old", "new"):
            dev[design].append(device_ms(new if design == "new" else old, 10,
                                         new_k if design == "new" else old_k))
        t[name], t[name + "_old"] = float(np.mean(runs["new"])), float(np.mean(runs["old"]))
        t[name + "_dev"] = float(np.mean(dev["new"]))
        t[name + "_old_dev"] = float(np.mean(dev["old"]))
        t[name + "_rounds"] = {"events": runs, "device": dev}
        t[name + "_call_dev"] = device_ms(new, 10)  # every kernel of the wrapper's call
        log(f"adc times {name} in turns (new, old, old, new): new {runs['new']} ms, {which} design "
            f"{runs['old']} ms; device time per call (profiler, same turns): kernel {dev['new']} ms "
            f"(the wrapper's whole call {t[name + '_call_dev']:.4g} ms), {which} design "
            f"{dev['old']} ms")
    t["adc_topk_fused_plan"] = fa.k8_plan(ADC_M, ADC_KS, ADC_BATCH)._asdict()
    # the card's practical bound for K6/K7's [64, n] f32 write
    sink = torch.empty((ADC_RANGE_BATCH, n), dtype=torch.float32, device=DEVICE)
    t["write_floor"] = device_ms(lambda: sink.fill_(0), 10)
    del sink
    log(f"adc: write-only floor (fill_ of [{ADC_RANGE_BATCH}, {n}] f32, profiler) "
        f"{t['write_floor']:.4g} ms")
    for name, ref, bnd, lookups in cases:
        t[name + "_plain"] = time_ms(ref, 2, warmup=1)
        t[name + "_bound"] = bnd
        t[name + "_lookups"] = lookups
        log(f"adc times {name}: kernel {t[name]:.4g} ms, plain {t[name + '_plain']:.4g} ms, "
            f"bound {bnd[0]:.4g} ms ({bnd[1]}), {lookups} lookups")
    t["sm_clock_mhz"] = sm_clock_under(lambda: fa.adc_topk_fused(codes, lut256, MAIN_K))
    log(f"adc: SM clock under K8 {t['sm_clock_mhz']:.0f} MHz (nvidia-smi clocks.sm, highest "
        "reading while it runs)")
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
    t.update(range_split(fa, codes, lut64, radius))
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


def range_split(fa, codes, lut, radius: float, calls: int = 7) -> dict:
    """range_scan_adc(strategy="auto") at B=64 split into K6 and the mask +
    stable-sort compaction (ops/range_query._compact): the median host wall
    of `calls` synchronised calls of each part, and the profiler's device
    time per call of the whole call and of K6's kernel in it."""
    from vectorindex_tpu_torch.ops import range_query as rq
    from vectorindex_tpu_torch.utils.config import Metric

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        lat = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(lat))

    dist = fa.adc_scan_u8(codes, lut)

    def whole():
        return rq.range_scan_adc(codes, lut, radius, max_results=ADC_RANGE_MAX, strategy="auto")

    def compact():
        return rq._compact(dist, rq._range_mask_from_dist(dist, radius, Metric.L2), ADC_RANGE_MAX)

    out = {"range_wall": wall(whole), "range_k6_wall": wall(lambda: fa.adc_scan_u8(codes, lut)),
           "range_compact_wall": wall(compact), "range_dev": device_ms(whole, 3),
           "range_k6_dev": device_ms(whole, 3, "adc_qlane_scan_kernel")}
    log(f"adc range_scan_adc B={ADC_RANGE_BATCH} split (median of {calls} calls): wall "
        f"{out['range_wall']:.4g} ms = K6 {out['range_k6_wall']:.4g} ms + mask and stable sort "
        f"{out['range_compact_wall']:.4g} ms; device time (profiler) {out['range_dev']:.4g} ms, "
        f"of it K6's kernel {out['range_k6_dev']:.4g} ms")
    return out


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


# ---------------------------------------------------------------------------
# phase 12: the host-rerank tier at capacity (bench.py's bench_hostpq)
# ---------------------------------------------------------------------------


def clustered_corpus_dev(n: int, d: int, nlist: int, seed: int, spread: float,
                         chunk: int = 1_000_000) -> torch.Tensor:
    """bench/synth.clustered_corpus's recipe on the card, from a seeded
    torch.Generator (not numpy's draws, so not that function's bytes; numpy
    takes ~3 min at 10M rows):
    centers N(0, 1) [nlist, d], uniform assignments, rows centers[assign] +
    spread·N(0, 1), scaled to unit norm → [n, d] f32 on DEVICE."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    centers = torch.randn(nlist, d, generator=gen, device=DEVICE)
    assign = torch.randint(0, nlist, (n,), generator=gen, device=DEVICE)
    x = torch.empty((n, d), device=DEVICE)
    for s in range(0, n, chunk):
        blk = torch.randn(min(chunk, n - s), d, generator=gen, device=DEVICE)
        blk.mul_(spread).add_(centers[assign[s : s + chunk]])
        x[s : s + chunk] = blk / blk.norm(dim=1, keepdim=True).clamp_min(1e-30)
    return x


def noisy_queries(x: np.ndarray, nq: int, seed: int, noise: float = HOSTPQ_NOISE) -> np.ndarray:
    """bench.py's _noisy_queries: held-out queries near corpus rows."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], nq, replace=False)
    return (x[idx] + noise * rng.standard_normal((nq, x.shape[1])).astype(np.float32)).astype(np.float32)


def hostpq_build(gpu: str):
    """The capacity index of bench_hostpq, built on the card → (state dict,
    host corpus, eval queries, truth (ids, k-th distance), stage seconds)."""
    from vectorindex_tpu_torch.bench import synth
    from vectorindex_tpu_torch.ops import kmeans as km
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.ops import rng as vrng

    n, d = HOSTPQ_ROWS, HOSTPQ_DIM
    secs = {}

    def stage(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    x_dev = clustered_corpus_dev(n, d, HOSTPQ_NLIST, HOSTPQ_SEED, HOSTPQ_SPREAD)
    stage("corpus_on_card", t0)
    t0 = time.perf_counter()
    x = x_dev.cpu().numpy()  # the host tier's f32 corpus, original row order
    secs["corpus_to_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    samp = torch.from_numpy(np.random.default_rng(42).choice(n, HOSTPQ_KM_SAMPLE, replace=False))
    res = km.kmeans(x_dev[samp.to(DEVICE)], km.KMeansConfig(
        k=HOSTPQ_NLIST, iters=HOSTPQ_KM_ITERS, algo="minibatch", batch_size=HOSTPQ_KM_BATCH, seed=42))
    centers = res.centroids
    del res
    stage("kmeans_train", t0)
    t0 = time.perf_counter()
    assign, _ = km.assign_clusters_chunked(x_dev, centers, chunk=65_536)
    stage("assign", t0)
    t0 = time.perf_counter()
    # bench/synth.pack_ivf's CSR layout (packed on the host, uploaded), no vectors;
    # each live packed row's corpus row (order), its packed row and its list
    arrays, order, probe_cap = synth.pack_ivf(None, assign, HOSTPQ_NLIST, with_vecs=False,
                                              device=DEVICE)
    order = torch.from_numpy(order).to(DEVICE).long()
    rows = torch.nonzero(arrays.row_ids >= 0).squeeze(1)
    lists = torch.repeat_interleave(torch.arange(HOSTPQ_NLIST, device=DEVICE), arrays.lengths.long())
    stage("pack", t0)
    t0 = time.perf_counter()
    psamp = torch.from_numpy(np.random.default_rng(7).choice(n, HOSTPQ_PQ_SAMPLE, replace=False))
    psamp = psamp.to(DEVICE)
    books = pq.pq_train_residual(vrng.make_generator(7, 0, device=DEVICE), x_dev[psamp], centers,
                                 assign[psamp], m=HOSTPQ_M, ks=HOSTPQ_KS, iters=HOSTPQ_PQ_ITERS)
    stage("pq_train", t0)
    t0 = time.perf_counter()
    total = arrays.row_ids.shape[0]
    codes = torch.zeros((total, HOSTPQ_M), dtype=torch.uint8, device=DEVICE)
    tcorr = torch.zeros(total, device=DEVICE)
    for s in range(0, n, 1_000_000):
        lst = lists[s : s + 1_000_000]
        c = pq.pq_encode_residual(x_dev[order[s : s + 1_000_000]], centers, lst, books, chunk=65_536)
        codes[rows[s : s + 1_000_000]] = c
        tcorr[rows[s : s + 1_000_000]] = pq.pq_row_corrections(c, lst, centers, books)
    stage("pq_encode", t0)
    evalq = noisy_queries(x, HOSTPQ_EVAL, seed=9)
    t0 = time.perf_counter()
    truth = chunked_truth(x_dev, evalq, MAIN_K)
    stage("truth", t0)
    lengths = arrays.lengths.cpu().numpy()
    log(f"hostpq build ({gpu}): {n}x{d} corpus drawn on the card (seeded torch.Generator), "
        f"nlist={HOSTPQ_NLIST} lists max {lengths.max()} mean {lengths.mean():.1f} "
        f"empty {(lengths == 0).sum()}, {total} slots, probe_cap {probe_cap}; seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    del x_dev, samp, psamp, assign, order, rows, lists
    state = dict(centroids=centers, arrays=arrays, codes=codes, tcorr=tcorr, books=books,
                 probe_cap=probe_cap)
    return state, x, evalq, truth, secs


def chunked_truth(x_dev, q: np.ndarray, k: int, chunk: int = 1_000_000):
    """Exact f32 brute force over all rows of x_dev in row chunks on the
    card, a running top-k merge → (ids [B, k], k-th distance [B]). Kept
    beside bench/synth.exact_truth_chunked, which returns the ids alone:
    the tie rule of recall_ids needs the k-th distance."""
    qd = torch.from_numpy(q).to(x_dev.device)
    qn = (qd * qd).sum(dim=1, keepdim=True)
    best_d = torch.full((q.shape[0], 0), float("inf"), device=x_dev.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.long, device=x_dev.device)
    for s in range(0, x_dev.shape[0], chunk):
        xc = x_dev[s : s + chunk]
        dist = (xc * xc).sum(dim=1)[None, :] - 2.0 * (qd @ xc.T) + qn
        cd, ci = torch.sort(dist, dim=1, stable=True)
        md = torch.cat([best_d, cd[:, :k]], dim=1)
        mi = torch.cat([best_i, ci[:, :k] + s], dim=1)
        md, sel = torch.sort(md, dim=1, stable=True)
        best_d, best_i = md[:, :k], torch.gather(mi, 1, sel[:, :k])
    return best_i, best_d[:, k - 1]


@contextlib.contextmanager
def plain_calls(module, names):
    """Count the calls of a module's plain versions `names` while inside."""
    calls = dict.fromkeys(names, 0)
    saved = {name: getattr(module, name) for name in names}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return call

    for name in names:
        setattr(module, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def host_cpu() -> str:
    """The host CPU's model (lscpu), architecture and cores."""
    import platform

    from vectorindex_tpu_torch.ops.rerank import host_threads

    model = "model not reported"
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.startswith("Model name")), model)
    except (OSError, subprocess.SubprocessError):
        pass
    return (f"{model} ({platform.machine()}), {os.cpu_count()} cores, {host_threads()} usable by "
            "this process")


def phase_hostpq(ap, gpu: str):
    """The capacity tier of bench_hostpq through HostRerankSession: the f32
    corpus in host RAM behind a CSRReader (native rerank), codes on the
    card. Drives per-call search, the pipelined stream and the recall
    batches with the counts set to 0 just before and read just after, then
    checks launches, plain versions, stream order, the rerank path, recall
    and device bytes per row, and times the stages."""
    import gc

    from vectorindex_tpu_torch.models.serve import HostRerankSession
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.ops import rerank as rr
    from vectorindex_tpu_torch.ops.ivf import ivf_select
    from vectorindex_tpu_torch.utils.config import Metric

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    state, x, evalq, (truth_ids, kth), secs = hostpq_build(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    dev_bytes = torch.cuda.memory_allocated() - base_bytes - truth_ids.numel() * 8 - kth.numel() * 4
    n = HOSTPQ_ROWS
    require(dev_bytes / n <= HOSTPQ_DEVICE_BYTES_MAX,
            f"hostpq: {dev_bytes / n:.2f} device bytes a row > {HOSTPQ_DEVICE_BYTES_MAX}")
    t0 = time.perf_counter()
    float(np.asarray(x[:, 0], dtype=np.float64).sum())  # one strided pass touches every page
    secs["prefault"] = time.perf_counter() - t0
    reader = rr.CSRReader(x, state["arrays"].row_ids.cpu().numpy())
    require(reader.vecs is x and rr.native_rerank_available(x), "hostpq: the reader copied the corpus")
    sess = HostRerankSession(
        state["centroids"], state["arrays"], state["codes"], state["tcorr"], state["books"], reader,
        nprobe=HOSTPQ_NPROBE, probe_cap=state["probe_cap"], rerank_c=HOSTPQ_RERANK_C,
        metric=Metric.L2, lookahead=HOSTPQ_LOOKAHEAD, device=DEVICE)
    b = HOSTPQ_BATCH
    qstream = noisy_queries(x, HOSTPQ_STREAM * b, seed=12)
    stream_batches = [qstream[i * b : (i + 1) * b] for i in range(HOSTPQ_STREAM)]
    eval_batches = [evalq[i : i + b] for i in range(0, HOSTPQ_EVAL, b)]
    rr.load_hostops()  # built before the timed run

    ap.reset_launches()
    rr.reset_rerank_counts()
    with plain_calls(ap, ("adc_probe_scores_ref", "adc_probe_scores_rankseg_ref")) as plain:
        sess.search(stream_batches[0], MAIN_K)  # warm
        t_stream = []
        for _ in range(2):  # the second pass finds the pinned blocks cached
            t0 = time.perf_counter()
            streamed = list(sess.stream(stream_batches, MAIN_K))
            t_stream.append(time.perf_counter() - t0)
        per_call, lat = [], []
        for qb in stream_batches:
            t0 = time.perf_counter()
            per_call.append(sess.search(qb, MAIN_K))
            lat.append(time.perf_counter() - t0)
        found = [sess.search(qb, MAIN_K) for qb in eval_batches]
    launches, impl, plain = dict(ap.LAUNCHES), dict(rr.RERANK_IMPL), dict(plain)
    n_batches = 1 + 3 * HOSTPQ_STREAM + len(eval_batches)
    log(f"hostpq main path ({gpu}): {n_batches} batches of B={b}: launches {launches}, rerank paths "
        f"{impl}, plain-version calls {plain}")
    require(launches == {"adc_probe_scores": n_batches, "adc_probe_scores_rankseg": 0,
                         "adc_probe_scores_v1": 0}, "hostpq: expected K9 once a batch and nothing else")
    require(not any(plain.values()), "hostpq: a plain version ran on the main path")
    require(impl == {"native": n_batches, "numpy": 0, "device": 0},
            f"hostpq: expected the native rerank on every batch, got {impl}")
    for i, ((sd, si), (wd, wi)) in enumerate(zip(streamed, per_call)):
        require(np.array_equal(si, wi) and np.array_equal(sd, wd),
                f"hostpq: stream batch {i} differs from search")

    # recall against exact f32 brute force over all rows
    got = torch.from_numpy(np.concatenate([f[1] for f in found])).to(DEVICE).long()
    d_got = torch.from_numpy(np.concatenate([f[0] for f in found])).to(DEVICE)
    hits = d_got <= kth[:, None] + RECALL_RTOL * kth.abs()[:, None]
    rec = float(hits.float().mean())
    set_rec = float((got[:, :, None] == truth_ids[:, None, :]).any(dim=2).float().mean())
    require(rec >= HOSTPQ_RECALL_MIN, f"hostpq: recall@{MAIN_K} {rec} < {HOSTPQ_RECALL_MIN}")

    # the same session through the kernels' plain versions: equal ids, equal bits
    with plain_versions(ap, PQ_KERNELS):
        for qb, (wd, wi) in zip(eval_batches[:2], found[:2]):
            pd, pi = sess.search(qb, MAIN_K)
            require(np.array_equal(pi, wi) and np.array_equal(pd, wd),
                    "hostpq: the plain versions give other results")
    # K9 bit for bit on this store's own tensors (with and without base and allow)
    qd = torch.from_numpy(eval_batches[0]).to(DEVICE)
    base, lists = ivf_select(qd, state["centroids"], nprobe=HOSTPQ_NPROBE, metric=Metric.L2)
    lists = lists.long()
    args = (pq.pq_lut_q_l2(qd, state["books"]).contiguous(),
            state["arrays"].starts[lists].contiguous(), state["arrays"].lengths[lists].contiguous(),
            state["codes"], state["tcorr"])
    kw = dict(nprobe=HOSTPQ_NPROBE, probe_cap=state["probe_cap"], m=HOSTPQ_M, ks=HOSTPQ_KS,
              packed_u4=False)
    allow = torch.rand(state["codes"].shape[0], generator=torch.Generator(device=DEVICE).manual_seed(3),
                       device=DEVICE) < 0.5
    errs = check_adc_kernels(ap, args, kw, "the hostpq store's tensors", base.float(), allow)

    # the numpy rerank on one batch against the native one, under their
    # contract (ops/rerank.host_rerank_dist_tol): distances within tol, ids
    # equal except where neighbouring native distances lie within tol; one
    # rank past k shows a swap across rank k
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    q0 = eval_batches[0]
    _, _, iids = sess.probe_candidates(q0, MAIN_K)
    iids_np = iids.cpu().numpy()
    xg = reader.gather_ids(iids_np.reshape(-1)).reshape(b, -1, HOSTPQ_DIM)
    nd, ni = rr.rerank_gathered_host(q0, xg, iids_np, k=MAIN_K + 1, metric=Metric.L2)
    wd, wi = rr.rerank_ids_host(x, iids_np, q0, k=MAIN_K + 1, metric=Metric.L2)
    require(np.array_equal(wi[:, :MAIN_K], found[0][1]), "hostpq: the native rerank is not repeatable")
    tol = rr.host_rerank_dist_tol(HOSTPQ_DIM, float((q0 * q0).sum(1).max() + (xg * xg).sum(2).max()))
    require(np.abs(nd - wd).max() <= tol, f"hostpq: numpy and native distances differ > {tol}")
    require(ids_match_up_to_ties(ni, wi, wd, MAIN_K, rtol=0.0, atol=tol),
            "hostpq: the numpy rerank gives other ids than the native one")
    same_rows = int((ni[:, :MAIN_K] == wi[:, :MAIN_K]).all(axis=1).sum())

    # stage times
    fn, cargs = sess.candidates_closure(MAIN_K)
    cand_ms = time_ms(lambda: fn(qd, *cargs), 20)
    cand_dev_ms = device_ms(lambda: fn(qd, *cargs), 20)
    d2h = []
    for _ in range(7):
        _, _, ids_dev = fn(qd, *cargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids_dev.cpu()
        d2h.append(time.perf_counter() - t0)
    rerank = []
    for _ in range(7):
        t0 = time.perf_counter()
        sess.rerank_host(iids_np, q0, MAIN_K)
        rerank.append(time.perf_counter() - t0)
    k9 = {"ms": time_ms(lambda: ap.adc_probe_scores(*args, **kw, base=base.float()), 50),
          "device_ms": device_ms(lambda: ap.adc_probe_scores(*args, **kw, base=base.float()), 20,
                                 "adc_probe"),
          "plain_ms": time_ms(lambda: ap.adc_probe_scores_ref(*args, **kw, base=base.float()), 3,
                              warmup=1),
          "bound": adc_bound(args, state["probe_cap"], HOSTPQ_M, False)}
    figs = dict(
        device_bytes_per_row=dev_bytes / n, host_bytes_per_row=x.strides[0],
        per_call_ms=1e3 * float(np.median(lat)), pipelined_qps=HOSTPQ_STREAM * b / t_stream[-1],
        candidates_ms=cand_ms, candidates_device_ms=cand_dev_ms, d2h_ms=1e3 * float(np.median(d2h)),
        rerank_ms=1e3 * float(np.median(rerank)), rerank_threads=rr.host_threads(),
        recall=rec, set_recall=set_rec, build_s=secs, k9=k9, c=iids_np.shape[1],
    )
    log(f"hostpq ({gpu}; host {host_cpu()}): recall@{MAIN_K} {rec} (set {set_rec}) over "
        f"{HOSTPQ_EVAL} queries; device {dev_bytes} bytes = {dev_bytes / n:.3f} B a row "
        f"(absolute {torch.cuda.memory_allocated()}), host {x.strides[0]} B a row; per call B={b} "
        f"median {figs['per_call_ms']:.4g} ms over {len(lat)}; stream of {HOSTPQ_STREAM} "
        f"(lookahead {HOSTPQ_LOOKAHEAD}) {t_stream[0] * 1e3:.4g} then {t_stream[1] * 1e3:.4g} ms = "
        f"{figs['pipelined_qps']:.1f} QPS; candidate stage {cand_ms:.4g} ms (events, "
        f"C={iids_np.shape[1]}), of it {cand_dev_ms:.4g} ms device time (profiler); ids D2H "
        f"{figs['d2h_ms']:.4g} ms; native rerank {figs['rerank_ms']:.4g} ms on "
        f"{figs['rerank_threads']} threads; K9 at B={b} nprobe={HOSTPQ_NPROBE} cap="
        f"{state['probe_cap']}: {k9['ms']:.4g} ms (events), device {k9['device_ms']:.5g} ms, plain "
        f"{k9['plain_ms']:.4g} ms, bound {k9['bound'][0]:.4g} ms ({k9['bound'][1]})")
    log(f"hostpq: stream equals per call batch by batch; the plain versions give equal ids and bits; "
        f"K9 equals its plain version bit for bit on the store's tensors; the numpy rerank gives "
        f"the native ids up to ties ({same_rows}/{b} rows exactly), distances within {tol:.3g} "
        f"(largest difference {np.abs(nd - wd).max():.3g})")
    del sess, state, reader, x
    gc.collect()
    torch.cuda.empty_cache()
    figs["phase_s"] = time.perf_counter() - t_phase
    log(f"hostpq: phase {figs['phase_s']:.1f} s")
    return launches, errs, figs

# ---------------------------------------------------------------------------
# phase 12: HNSW (no hand-written kernel: its search is plain torch)
# ---------------------------------------------------------------------------


def hnsw_graph_fields(idx) -> dict:
    """Every field that defines an HNSW graph, as numpy."""
    return {"levels": idx._levels.copy(), "lookup0": idx._lookup0.copy(), "entry": idx._entry,
            "layers": [(np.asarray(l.node_ids), l.nbrs[: l.count].copy()) for l in idx._layers]}


def same_graph(a: dict, b: dict) -> bool:
    return (a["entry"] == b["entry"] and np.array_equal(a["levels"], b["levels"])
            and np.array_equal(a["lookup0"], b["lookup0"]) and len(a["layers"]) == len(b["layers"])
            and all(np.array_equal(na, nb_) and np.array_equal(ea, eb)
                    for (na, ea), (nb_, eb) in zip(a["layers"], b["layers"])))


def result_ids(rows, k: int) -> np.ndarray:
    out = np.full((len(rows), k), -1, dtype=np.int64)
    for i, row in enumerate(rows):
        out[i, : len(row)] = [r.id for r in row]
    return out


def masked_truth(x_dev, sq_dev, q: np.ndarray, k: int, live: np.ndarray):
    """brute_force over the rows where `live` holds (the others at +inf)."""
    dist, _, _ = brute_force(x_dev, sq_dev, q, k)
    dist[:, torch.from_numpy(~live).to(dist.device)] = float("inf")
    sd, order = torch.sort(dist, dim=1, stable=True)
    return dist, sd[:, k - 1], order[:, :k]


def search_profile(fn) -> tuple[int, float]:
    """(CUDA kernel launches, device busy ms) of one fn() call, from
    torch.profiler (copies and memsets are not launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches = sum(1 for e in dev if not e.name.startswith(("Memcpy", "Memset")))
    busy = sum(e.device_time_total for e in dev) / 1e3
    require(launches > 0 and busy > 0, "the profiler saw no device work in device_search")
    return launches, busy


def hnsw_int_builds(metric, x: np.ndarray, q: np.ndarray, k: int):
    """Build one index on the card and one on the host over the same
    integer-valued rows → (graphs equal, ids equal, recall card, recall
    host, build s card, build s host)."""
    from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex

    out = {}
    for device in ("cuda", "cpu"):
        idx = HNSWIndex(x.shape[1], metric, HNSWConfig(**HNSW_INT_CONFIG), device=device)
        t0 = time.perf_counter()
        idx.insert_batch(list(range(x.shape[0])), x)
        idx.statistics()
        torch.cuda.synchronize()
        out[device] = (idx, time.perf_counter() - t0)
    (gi, tg), (ci, tc) = out["cuda"], out["cpu"]
    ids_g = result_ids(gi.batch_search(q, k), k)
    ids_c = result_ids(ci.batch_search(q, k), k)
    return same_graph(hnsw_graph_fields(gi), hnsw_graph_fields(ci)), np.array_equal(ids_g, ids_c), \
        ids_g, ids_c, tg, tc


def phase_hnsw(gpu: str, ps, api):
    """HNSWIndex on the card at bench_hnsw's shape: build, searches (B=256,
    B=8, the stream, filters, tombstones), device_search free of host
    synchronisation, the acceleration seam (phase_api_hnsw), the sharded
    index over the same rows (phase_sharded_hnsw), the card against the
    host on integer-valued rows."""
    from vectorindex_tpu_torch.bench.synth import lowdim_corpus, lowdim_queries
    from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex
    from vectorindex_tpu_torch.utils.config import Metric
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    t_phase = time.perf_counter()
    figs = {}
    k, bsz = MAIN_K, HNSW_BATCH
    x, W = lowdim_corpus(HNSW_ROWS, HNSW_DIM, dz=HNSW_DZ, seed=HNSW_SEED)
    qs = lowdim_queries(W, bsz * (HNSW_BATCHES + HNSW_STREAM))
    idx = HNSWIndex(HNSW_DIM, Metric.L2, HNSWConfig(), device="cuda")
    t0 = time.perf_counter()
    idx.insert_batch(list(range(HNSW_ROWS)), x)
    st = idx.statistics()
    torch.cuda.synchronize()
    figs["build_s"] = time.perf_counter() - t0
    figs["max_level"], figs["avg_degree_l0"] = st.details["max_level"], st.details["avg_degree_l0"]
    log(f"hnsw: built {HNSW_ROWS} x {HNSW_DIM} in {figs['build_s']:.2f} s (levels "
        f"{[l.count for l in idx._layers]}, mean level-0 degree {figs['avg_degree_l0']:.2f})")
    x_dev = torch.from_numpy(x).cuda()
    sq_dev = (x_dev * x_dev).sum(dim=1)

    # B=256 batches: recall and walls
    walls, recalls = [], []
    for i in range(HNSW_BATCHES):
        qb = qs[i * bsz : (i + 1) * bsz]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.batch_search(qb, k)
        walls.append(1e3 * (time.perf_counter() - t0))
        dist, kth, truth = brute_force(x_dev, sq_dev, qb, k)
        recalls.append(recall(res, dist, kth, truth, k)[0])
    figs["recall"] = float(np.mean(recalls))
    figs["b256_ms"] = float(np.median(walls[1:]))
    figs["qps"] = bsz / figs["b256_ms"] * 1e3
    require(figs["recall"] >= HNSW_RECALL_MIN, f"hnsw recall@{k} {figs['recall']} < {HNSW_RECALL_MIN}")
    small = []
    for i in range(HNSW_SMALL_CALLS):
        qb = qs[i * SMALL_BATCH : (i + 1) * SMALL_BATCH]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.batch_search(qb, k)
        small.append(1e3 * (time.perf_counter() - t0))
    dist, kth, truth = brute_force(x_dev, sq_dev, qs[:SMALL_BATCH], k)
    figs["b8_recall"] = recall(idx.batch_search(qs[:SMALL_BATCH], k), dist, kth, truth, k)[0]
    figs["b8_ms"] = float(np.median(small[1:]))
    log(f"hnsw: recall@{k} {figs['recall']} at B={bsz} (per batch {recalls}), {figs['b8_recall']} "
        f"at B={SMALL_BATCH}; walls B={bsz} {walls} ms (median {figs['b256_ms']:.4g}, "
        f"{figs['qps']:.1f} QPS), B={SMALL_BATCH} median {figs['b8_ms']:.4g} ms")

    # device_search: no host synchronisation, its launches and busy time
    q_dev = torch.from_numpy(qs[:bsz]).cuda()
    warm = idx.device_search(q_dev, k)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = idx.device_search(q_dev, k)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    require(all(torch.equal(a, b) for a, b in zip(warm, got)), "device_search is not repeatable")
    figs["launches"], figs["busy_ms"] = search_profile(lambda: idx.device_search(q_dev, k))
    figs["device_search_ms"] = time_ms(lambda: idx.device_search(q_dev, k), 5)
    log(f"hnsw: device_search B={bsz} ran under set_sync_debug_mode('error'); "
        f"{figs['launches']} CUDA launches, device busy {figs['busy_ms']:.4g} ms of "
        f"{figs['device_search_ms']:.4g} ms by events (idle share "
        f"{1 - figs['busy_ms'] / figs['device_search_ms']:.3f})")

    # the stream against per-call search, batch by batch
    batches = [qs[(HNSW_BATCHES + i) * bsz : (HNSW_BATCHES + i + 1) * bsz]
               for i in range(HNSW_STREAM)]
    list(idx.batch_search_stream(batches[:2], k, lookahead=HNSW_LOOKAHEAD))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = list(idx.batch_search_stream(batches, k, lookahead=HNSW_LOOKAHEAD))
    stream_s = time.perf_counter() - t0
    figs["stream_qps"] = HNSW_STREAM * bsz / stream_s
    for qb, rows_s in zip(batches, streamed):
        rows_p = idx.batch_search(qb, k)
        require([[(r.id, r.score) for r in row] for row in rows_s]
                == [[(r.id, r.score) for r in row] for row in rows_p],
                "batch_search_stream differs from batch_search")
    log(f"hnsw: stream of {HNSW_STREAM} x {bsz} (lookahead {HNSW_LOOKAHEAD}) equals batch_search; "
        f"{figs['stream_qps']:.1f} QPS")
    with api.timed("api hnsw"):
        phase_api_hnsw(idx, qs[:SMALL_BATCH], api)

    # filters and tombstones
    rng = np.random.default_rng(HNSW_SEED)
    qb = qs[:bsz]
    allow = rng.choice(HNSW_ROWS, int(HNSW_ALLOW_FRAC * HNSW_ROWS), replace=False)
    live = np.zeros(HNSW_ROWS, dtype=bool)
    live[allow] = True
    res = idx.batch_search(qb, k, allow_ids=set(allow.tolist()))
    require(all(live[r.id] for row in res for r in row), "allow_ids let another id through")
    dist, kth, truth = masked_truth(x_dev, sq_dev, qb, k, live)
    figs["allow10_recall"] = recall(res, dist, kth, truth, k)[0]
    require(figs["allow10_recall"] >= HNSW_FILTER_RECALL_MIN,
            f"hnsw allow_ids 10% recall {figs['allow10_recall']} < {HNSW_FILTER_RECALL_MIN}")
    few = allow[:HNSW_ALLOW_FEW]
    live_few = np.zeros(HNSW_ROWS, dtype=bool)
    live_few[few] = True
    res = idx.batch_search(qb, k, allow_ids=set(few.tolist()))
    dist, _, truth = masked_truth(x_dev, sq_dev, qb, k, live_few)
    sd = torch.sort(dist, dim=1, stable=True).values[:, : k + 1].cpu().numpy()
    require(ids_match_up_to_ties(result_ids(res, k), truth.cpu().numpy(), sd, k),
            "the exact-scan filter regime differs from brute force")
    removed = rng.choice(HNSW_ROWS, int(HNSW_REMOVE_FRAC * HNSW_ROWS), replace=False)
    for i in removed.tolist():
        idx.remove(i)
    alive = np.ones(HNSW_ROWS, dtype=bool)
    alive[removed] = False
    res = idx.batch_search(qb, k)
    require(all(alive[r.id] for row in res for r in row), "a removed id was returned")
    dist, kth, truth = masked_truth(x_dev, sq_dev, qb, k, alive)
    figs["removed_recall"] = recall(res, dist, kth, truth, k)[0]
    require(figs["removed_recall"] >= HNSW_RECALL_MIN,
            f"hnsw recall after removals {figs['removed_recall']} < {HNSW_RECALL_MIN}")
    log(f"hnsw: allow_ids 10% recall@{k} {figs['allow10_recall']} (every result allowed), "
        f"{HNSW_ALLOW_FEW} ids equal brute force up to ties; {removed.size} removed: none returned, "
        f"recall@{k} {figs['removed_recall']}")
    phase_persist_hnsw(idx, qb, ps, figs["build_s"])
    del idx
    with api.timed("sharded hnsw"):
        phase_sharded_hnsw(x, W, qb, x_dev, sq_dev, ps, api)
    del x_dev, sq_dev
    torch.cuda.empty_cache()

    # the card against the host on integer-valued rows
    rng = np.random.default_rng(HNSW_SEED + 1)
    xi = rng.integers(-8, 9, (HNSW_INT_ROWS, HNSW_INT_DIM)).astype(np.float32)
    qi = rng.integers(-8, 9, (HNSW_INT_QUERIES, HNSW_INT_DIM)).astype(np.float32)
    figs["int_builds_s"] = {}
    for metric in (Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE):
        graph_eq, ids_eq, ids_g, ids_c, tg, tc = hnsw_int_builds(metric, xi, qi, k)
        figs["int_builds_s"][metric.value] = (tg, tc)
        if metric == Metric.COSINE:  # normalisation breaks exactness: recall only
            xn = xi / np.linalg.norm(xi, axis=1, keepdims=True)
            qn = qi / np.linalg.norm(qi, axis=1, keepdims=True)
            truth = np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :k]
            rec = [float(np.mean([len(set(a) & set(t)) / k for a, t in zip(ids, truth)]))
                   for ids in (ids_g, ids_c)]
            require(abs(rec[0] - rec[1]) <= HNSW_INT_COSINE_GAP, f"hnsw cosine integer recall {rec}")
            log(f"hnsw card vs host cosine: graphs equal {graph_eq}, ids equal {ids_eq}, recall@{k} "
                f"card {rec[0]} host {rec[1]}; builds {tg:.2f} s / {tc:.2f} s")
        else:
            require(graph_eq, f"hnsw {metric.value}: the card's graph differs from the host's")
            require(ids_eq, f"hnsw {metric.value}: the card's ids differ from the host's")
            log(f"hnsw card vs host {metric.value}: graphs equal field by field, search ids equal; "
                f"builds {tg:.2f} s / {tc:.2f} s")
    figs["phase_s"] = time.perf_counter() - t_phase
    log(f"hnsw: phase {figs['phase_s']:.1f} s")
    return figs


def phase_kmeans_replay():
    """K-means on the card replayed from its seed: IVFIndex.optimize's
    Lloyd and pq_train, each trained twice, must give the same bits."""
    from vectorindex_tpu_torch.bench.synth import lowdim_corpus
    from vectorindex_tpu_torch.models.ivf import IVFConfig
    from vectorindex_tpu_torch.ops import kmeans as km
    from vectorindex_tpu_torch.ops import pq
    from vectorindex_tpu_torch.ops import rng as vrng

    x, _ = lowdim_corpus(KM_ROWS, KM_DIM, seed=SEED)
    xd = torch.from_numpy(x).cuda()
    cfg = km.KMeansConfig(k=KM_NLIST, iters=IVFConfig().train_iters, algo="lloyd",
                          seed=IVFConfig().seed)
    runs, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        res = km.kmeans(xd, cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        runs.append(res)
    require(torch.equal(runs[0].centroids, runs[1].centroids)
            and torch.equal(runs[0].assignments, runs[1].assignments),
            "k-means on the card gave other centroids from the same seed")
    xp, _ = lowdim_corpus(KM_PQ_ROWS, KM_PQ_DIM, seed=SEED + 1)
    xpd = torch.from_numpy(xp).cuda()
    books, pq_secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        books.append(pq.pq_train(vrng.make_generator(SEED, 1, device="cuda"), xpd, m=KM_PQ_M,
                                 ks=256, iters=KM_PQ_ITERS).centroids)
        torch.cuda.synchronize()
        pq_secs.append(time.perf_counter() - t0)
    require(torch.equal(books[0], books[1]), "pq_train on the card gave other codebooks from the same seed")
    figs = {"kmeans_s": secs, "kmeans_iters": runs[0].iterations, "pq_train_s": pq_secs}
    log(f"k-means replay: Lloyd nlist={KM_NLIST} over {KM_ROWS} x {KM_DIM} ({runs[0].iterations} "
        f"iterations) and pq_train pq{KM_PQ_M} over {KM_PQ_ROWS} x {KM_PQ_DIM}, each twice: equal "
        f"bits; seconds {secs}, {pq_secs}")
    return figs



# ---------------------------------------------------------------------------
# phase 14: persistence (binary containers, the durable IVF journal)
# ---------------------------------------------------------------------------

#: mutations journaled through the durable IVF container before the crash
#: stand-in (close_durable with no checkpoint), then before the checkpoint
PERSIST_INSERTS, PERSIST_REMOVES, PERSIST_UPDATES, PERSIST_META = 1000, 100, 100, 100
PERSIST_CHECKPOINT_INSERTS = 100


class Persist:
    """phase_persist's state: the directory its files go to (removed by
    close()), the figures of each index and its kernels' launches."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_persist_")
        self.figs: dict = {}
        self.launches: dict = {}

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def count(self, module, names) -> None:
        for name in names:
            self.launches[name] = self.launches.get(name, 0) + module.LAUNCHES[name]

    def close(self) -> None:
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)


def same_rows(got, want, what: str) -> None:
    """A restored index's results equal its live self's: ids and scores."""
    require([[(r.id, r.score) for r in row] for row in got]
            == [[(r.id, r.score) for r in row] for row in want],
            f"{what}: the restored index's results differ from the live index's")


def timed_load(load, first):
    """(index, load s, s from the load's start to first()'s result, result)."""
    t0 = time.perf_counter()
    idx = load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    res = first(idx)
    return idx, load_s, time.perf_counter() - t0, res


def phase_persist_flat(sf, idx, batches, ps: Persist) -> None:
    """The flat main path's 1M x 128 bf16 index: save_container,
    load_container (the device mirror pre-warmed from the norm cache), B=8
    and B=256 through K1/K2 equal to the live index bit for bit, no strict
    fallback; load_index returns a FlatIndex. The save is split on the host
    clock: the id map's JSON, the CRC's rate over the rows (a save checks
    each section twice), and the rest (the copy into the mapping, msync)."""
    from vectorindex_tpu_torch.models import FlatIndex, load_index
    from vectorindex_tpu_torch.persistence import container
    from vectorindex_tpu_torch.utils.telemetry import TELEM

    small, big = batches[-1], batches[0]
    want_small, want_big = idx.batch_search(small, MAIN_K), idx.batch_search(big, MAIN_K)
    path = ps.path("flat.vx")
    t0 = time.perf_counter()
    idx.save_container(path)
    f = {"save_s": time.perf_counter() - t0, "gb": os.path.getsize(path) / 1e9}
    rows = idx._vectors[: idx._next_slot]
    t0 = time.perf_counter()
    container.load_library().vc_crc32(rows.ctypes.data, rows.nbytes)
    f["crc_gb_s"] = rows.nbytes / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    idx._idmap.to_blob()
    f["idmap_json_s"] = time.perf_counter() - t0
    f["save_rest_s"] = f["save_s"] - f["idmap_json_s"] - 2 * rows.nbytes / 1e9 / f["crc_gb_s"]
    TELEM.reset()
    TELEM.enable()
    sf.reset_launches()
    loaded, f["load_s"], f["first_s"], got_small = timed_load(
        lambda: FlatIndex.load_container(path, idx.device), lambda i: i.batch_search(small, MAIN_K))
    got_big = loaded.batch_search(big, MAIN_K)
    TELEM.disable()
    ps.count(sf, ("bin_candidates", "count_below"))
    fallback = TELEM.snapshot()["counters"].get("flat.verify_fallback", 0)
    require(loaded.storage_dtype == torch.bfloat16, f"flat reloads as {loaded.storage_dtype}")
    require(sf.LAUNCHES["bin_candidates"] > 0 and sf.LAUNCHES["count_below"] > 0
            and sf.DESIGN_LAUNCHES["wgmma"] == {n: sf.LAUNCHES[n] for n in ("bin_candidates",
                                                                           "count_below")}
            and not any(sf.LAUNCHES[name] for name in FIRST_DESIGNS),
            f"the reloaded flat index did not run K1/K2 on the wgmma design: {sf.LAUNCHES}, "
            f"{sf.DESIGN_LAUNCHES}")
    require(fallback == 0, f"{fallback} queries of the reloaded flat index fell back")
    same_rows(got_small, want_small, f"flat B={len(small)}")
    same_rows(got_big, want_big, f"flat B={len(big)}")
    del loaded
    require(type(load_index(path, idx.device)) is FlatIndex, "load_index of a flat container")
    os.remove(path)
    ps.figs["flat"] = f
    log(f"persist flat: {MAIN_ROWS} x {MAIN_DIM} bf16: save {f['save_s']:.3f} s (id map JSON "
        f"{f['idmap_json_s']:.3f} s, two CRC passes at {f['crc_gb_s']:.3f} GB/s, the rest "
        f"{f['save_rest_s']:.3f} s), {f['gb']:.3f} GB, "
        f"load {f['load_s']:.3f} s, first result (B={len(small)}) {f['first_s']:.3f} s after the "
        f"load began; B={len(small)}/{len(big)} ids and scores equal the live index's, K1/K2 "
        f"launches {dict((n, sf.LAUNCHES[n]) for n in ('bin_candidates', 'count_below'))}, no "
        f"strict fallback; load_index -> FlatIndex")


def phase_persist_ivf(kp, idx, batches, bigq, ps: Persist) -> None:
    """The IVF main path's 1M x 128 bf16 index: enable_durable, journaled
    inserts, removes, vector and metadata updates, close_durable with no
    checkpoint (a crash), load_durable: count, ids and storage dtype equal,
    B=8 (K3) and B=256 (K4) equal to the live index; then durable again, a
    checkpoint (the generation up by one), load_index again: equal again."""
    from vectorindex_tpu_torch.models import IVFIndex, load_index
    from vectorindex_tpu_torch.persistence.container import Container

    path, f = ps.path("ivf.vx"), {}
    q8 = batches[0]
    t0 = time.perf_counter()
    idx.enable_durable(path)
    f["save_s"], f["gb"] = time.perf_counter() - t0, os.path.getsize(path) / 1e9
    rng = np.random.default_rng(SEED)
    live_ids = rng.permutation(IVF_ROWS)
    base = np.stack([idx._vectors[idx._idmap.lookup(int(i))]
                     for i in live_ids[:PERSIST_INSERTS + PERSIST_UPDATES]])
    moved = base + 0.05 * rng.standard_normal(base.shape, dtype=np.float32)
    moved /= np.linalg.norm(moved, axis=1, keepdims=True)
    removed = live_ids[-PERSIST_REMOVES:].tolist()
    updated = live_ids[PERSIST_INSERTS: PERSIST_INSERTS + PERSIST_UPDATES].tolist()
    tagged = live_ids[-PERSIST_REMOVES - PERSIST_META: -PERSIST_REMOVES].tolist()
    n_mut = PERSIST_INSERTS + PERSIST_REMOVES + PERSIST_UPDATES + PERSIST_META
    t0 = time.perf_counter()
    idx.insert_batch(list(range(IVF_ROWS, IVF_ROWS + PERSIST_INSERTS)), moved[:PERSIST_INSERTS])
    for i in removed:
        idx.remove(i)
    for i, v in zip(updated, moved[PERSIST_INSERTS:]):
        idx.update(i, vector=v)
    for i in tagged:
        idx.update(i, metadata={"tag": i})
    f["journal_s"] = time.perf_counter() - t0
    f["mutations_per_s"] = n_mut / f["journal_s"]
    idx.close_durable()  # no checkpoint: the journal alone carries the mutations
    want8, want256 = idx.batch_search(q8, MAIN_K), idx.batch_search(bigq, MAIN_K)
    kp.reset_launches()
    loaded, f["load_s"], f["first_s"], got8 = timed_load(
        lambda: IVFIndex.load_durable(path, idx.device), lambda i: i.batch_search(q8, MAIN_K))
    got256 = loaded.batch_search(bigq, MAIN_K)
    ps.count(kp, ("ivf_probe_topc", "ivf_probe_scores"))
    require(kp.LAUNCHES["ivf_probe_topc"] > 0 and kp.LAUNCHES["ivf_probe_scores"] > 0,
            f"the reloaded IVF index did not run K3 and K4: {kp.LAUNCHES}")
    require(loaded.count == idx.count == IVF_ROWS + PERSIST_INSERTS - PERSIST_REMOVES,
            f"ivf reloads {loaded.count} rows, live {idx.count}")
    require(dict(loaded._idmap.items()) == dict(idx._idmap.items()), "ivf reloads other ids")
    require(loaded.storage_dtype == torch.bfloat16, f"ivf reloads as {loaded.storage_dtype}")
    require(all(loaded._metadata.get(loaded._idmap.lookup(i)) == {"tag": i} for i in tagged),
            "a journaled metadata update was lost")
    same_rows(got8, want8, f"ivf journal B={len(q8)}")
    same_rows(got256, want256, f"ivf journal B={len(bigq)}")
    del loaded

    idx.enable_durable(path)
    gen = idx._durable.generation
    idx.insert_batch(list(range(IVF_ROWS + PERSIST_INSERTS,
                                IVF_ROWS + PERSIST_INSERTS + PERSIST_CHECKPOINT_INSERTS)),
                     moved[:PERSIST_CHECKPOINT_INSERTS] * -1.0)
    t0 = time.perf_counter()
    idx.checkpoint()
    f["checkpoint_s"] = time.perf_counter() - t0
    idx.close_durable()
    with Container.open(path) as c:
        require(c.generation == gen + 1, f"checkpoint: generation {c.generation}, expected {gen + 1}")
    want8, want256 = idx.batch_search(q8, MAIN_K), idx.batch_search(bigq, MAIN_K)
    loaded, f["load2_s"], _, got8 = timed_load(
        lambda: load_index(path, idx.device), lambda i: i.batch_search(q8, MAIN_K))
    require(type(loaded) is IVFIndex, f"load_index of a durable IVF container gave {type(loaded)}")
    same_rows(got8, want8, f"ivf checkpoint B={len(q8)}")
    same_rows(loaded.batch_search(bigq, MAIN_K), want256, f"ivf checkpoint B={len(bigq)}")
    del loaded
    os.remove(path)
    ps.figs["ivf"] = f
    log(f"persist ivf: {IVF_ROWS} x {IVF_DIM} bf16 nlist={IVF_NLIST}: enable_durable (save) "
        f"{f['save_s']:.3f} s, {f['gb']:.3f} GB; journaled {PERSIST_INSERTS} inserts, "
        f"{PERSIST_REMOVES} removes, {PERSIST_UPDATES} vector and {PERSIST_META} metadata updates "
        f"in {f['journal_s']:.3f} s ({f['mutations_per_s']:.1f} mutations/s); close without a "
        f"checkpoint, load_durable {f['load_s']:.3f} s, first result {f['first_s']:.3f} s; count, "
        f"ids, dtype and B={len(q8)} (K3) / B={len(bigq)} (K4) equal the live index's; "
        f"checkpoint {f['checkpoint_s']:.3f} s (generation {gen} -> {gen + 1}), load_index "
        f"{f['load2_s']:.3f} s: equal again")


def phase_persist_pq(ap, name, idx, batches, bigq, ps: Persist) -> None:
    """An IVF-PQ main-path index: enable_durable, close_durable,
    load_durable (pq16) or load_index (pq32x4): the codebooks' bits equal,
    B=8 (K10) and, for pq16, B=256 (K9) equal to the live index; spill_eps
    kept and every row k distinct ids (pq32x4)."""
    from vectorindex_tpu_torch.models import IVFIndex, IVFPQIndex, load_index

    path, f = ps.path(f"{name}.vx"), {}
    q8 = batches[0]
    t0 = time.perf_counter()
    idx.enable_durable(path)
    f["save_s"], f["gb"] = time.perf_counter() - t0, os.path.getsize(path) / 1e9
    idx.close_durable()
    want8 = idx.batch_search(q8, MAIN_K)
    want_big = idx.batch_search(bigq, MAIN_K) if name == "pq16" else None
    load = ((lambda: IVFIndex.load_durable(path, idx.device)) if name == "pq16"
            else (lambda: load_index(path, idx.device)))
    ap.reset_launches()
    loaded, f["load_s"], f["first_s"], got8 = timed_load(load, lambda i: i.batch_search(q8, MAIN_K))
    require(type(loaded) is IVFPQIndex and loaded.config == idx.config,
            f"{name} reloads as {type(loaded).__name__} {loaded.config}")
    require(torch.equal(loaded._books.centroids, idx._books.centroids)
            and torch.equal(loaded._books.sqnorms, idx._books.sqnorms), f"{name}: codebooks differ")
    same_rows(got8, want8, f"{name} B={len(q8)}")
    kernels = ["adc_probe_scores_rankseg"]
    if name == "pq16":
        same_rows(loaded.batch_search(bigq, MAIN_K), want_big, f"{name} B={len(bigq)}")
        kernels.append("adc_probe_scores")
    ps.count(ap, kernels)
    require(all(ap.LAUNCHES[k] > 0 for k in kernels), f"{name}: the reloaded index ran {ap.LAUNCHES}")
    require(all(len({r.id for r in row}) == len(row) == MAIN_K for row in got8),
            f"{name}: a reloaded row holds a duplicate id or fewer than k")
    del loaded
    os.remove(path)
    ps.figs[name] = f
    log(f"persist {name}: {PQ_ROWS} x {PQ_DIM} spill_eps={idx.config.spill_eps}: save "
        f"{f['save_s']:.3f} s, {f['gb']:.3f} GB, load {f['load_s']:.3f} s, first result (encode + "
        f"B={len(q8)}) {f['first_s']:.3f} s; codebooks equal bits, results equal the live index's "
        f"through {kernels}, every row {MAIN_K} distinct ids")


def phase_persist_hnsw(idx, q, ps: Persist, build_s: float) -> None:
    """The HNSW main path's 100k x 128 index (1% removed): save_container,
    load_container with no build step, the graph equal field by field, a
    B=256 search equal in ids and distances; load_index returns an
    HNSWIndex."""
    from vectorindex_tpu_torch.models import HNSWIndex, load_index

    path, f = ps.path("hnsw.vx"), {"build_s": build_s}
    want = idx.batch_search(q, MAIN_K)
    graph = hnsw_graph_fields(idx)
    t0 = time.perf_counter()
    idx.save_container(path)
    f["save_s"], f["gb"] = time.perf_counter() - t0, os.path.getsize(path) / 1e9
    builds = []
    build_chunk = HNSWIndex._build_chunk
    HNSWIndex._build_chunk = lambda self, slots: builds.append(len(slots))
    try:
        loaded, f["load_s"], f["first_s"], got = timed_load(
            lambda: HNSWIndex.load_container(path, idx.device), lambda i: i.batch_search(q, MAIN_K))
    finally:
        HNSWIndex._build_chunk = build_chunk
    require(not builds and not loaded._pending, f"hnsw load ran a build step: {builds}")
    require(same_graph(hnsw_graph_fields(loaded), graph), "hnsw: the reloaded graph differs")
    same_rows(got, want, f"hnsw B={len(q)}")
    del loaded
    require(type(load_index(path, idx.device)) is HNSWIndex, "load_index of an HNSW container")
    os.remove(path)
    ps.figs["hnsw"] = f
    log(f"persist hnsw: {HNSW_ROWS} x {HNSW_DIM}: save {f['save_s']:.3f} s, {f['gb']:.4f} GB, load "
        f"{f['load_s']:.3f} s (build {build_s:.2f} s), first result (B={len(q)}) {f['first_s']:.3f} "
        f"s; no build step, graph equal field by field, ids and distances equal")


def persist_summary(ps: Persist, gpu: str) -> str:
    """One line of the phase's figures beside the card."""
    parts = []
    for name in ("flat", "ivf", "pq16", "pq32x4", "hnsw"):
        f = ps.figs[name]
        parts.append(f"{name} save {f['save_s']:.3f} s load {f['load_s']:.3f} s {f['gb']:.4f} GB "
                     f"first result {f['first_s']:.3f} s")
    ivf, hnsw, flat = ps.figs["ivf"], ps.figs["hnsw"], ps.figs["flat"]
    parts[0] += (f" (id map JSON {flat['idmap_json_s']:.3f} s, CRC {flat['crc_gb_s']:.3f} GB/s, "
                 f"the rest {flat['save_rest_s']:.3f} s)")
    return (f"persist: gpu {gpu}; " + "; ".join(parts)
            + f"; journaled {ivf['mutations_per_s']:.1f} mutations/s; load_durable at "
            f"{IVF_ROWS} rows {ivf['load_s']:.3f} s (after a checkpoint, load_index "
            f"{ivf['load2_s']:.3f} s); hnsw load {hnsw['load_s']:.3f} s against build "
            f"{hnsw['build_s']:.2f} s; launches {ps.launches}")


# ---------------------------------------------------------------------------
# phase_api: the verified flat route, MIPS through an L2 index, the
# acceleration seam; phase_sharded: sharding over a mesh of devices held by
# one process. Each part runs while the index it reuses is alive.
# ---------------------------------------------------------------------------

#: the verified route (ops/scan.scan_topk_verified): a bf16 index at
#: d = 8,192, past the FMA design, all 2^17 slots live (the capacity of
#: LARGE_SCAN_THRESHOLD), and the flat main path's rows as a manhattan f32
#: index (capacity 2^20); both searched at B=8 and B=64 (the bf16 index at
#: B=8 is below VERIFIED_MIN_BLOCK: the strict side of the selection)
VERIFIED_DIM, VERIFIED_ROWS, VERIFIED_BATCHES = 8192, 1 << 17, (8, 64)
#: sharding: shards of one card beside the mesh of the visible cards
SHARDS_ON_ONE_CARD = 4
SHARDED_PQ_RECALL_MIN = 0.85  # PERF.md §2's pq16 limit at nprobe=32
#: sharded HNSW: the HNSW main path's config (bench_hnsw's defaults) and the
#: rows inserted after the bulk build (the tail buffer)
HNSW_SHARDED_CONFIG: dict = {}  # HNSWConfig()
SHARDED_HNSW_TAIL = 500


class Api:
    """phase_api / phase_sharded's figures and their kernels' launches by
    path ("mips", "accel"), each run's counted from 0 just before it and
    read just after."""

    def __init__(self):
        self.figs: dict = {}
        self.launches: dict = {}
        self.seconds: dict = {}

    def count(self, path: str, module, names) -> None:
        counts = self.launches.setdefault(path, {})
        for name in names:
            counts[name] = counts.get(name, 0) + module.LAUNCHES[name]

    @contextlib.contextmanager
    def timed(self, name: str):
        """Host-clock seconds of one part, kept under `name` ("api ..." or
        "sharded ...")."""
        t0 = time.perf_counter()
        yield
        self.seconds[name] = time.perf_counter() - t0


def counters_of(fn):
    """(fn(), telemetry counters of the call)."""
    from vectorindex_tpu_torch.utils.telemetry import TELEM

    TELEM.reset()
    TELEM.enable()
    try:
        out = fn()
    finally:
        TELEM.disable()
    return out, TELEM.snapshot()["counters"]


def walls(fn, n: int = 3) -> float:
    """Median host-clock seconds of fn() after a synchronize, ended by one."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def card_mesh(shards: int):
    """`shards` shards of the first card (a mesh may repeat a device)."""
    from vectorindex_tpu_torch.parallel import make_mesh

    return make_mesh(shards, devices=[torch.device(DEVICE)] * shards)


def rows_ids(res) -> np.ndarray:
    return np.array([[r.id for r in row] for row in res])


def verified_route(sf, idx, q: np.ndarray, truth, label: str, peak_bound=None,
                   k: int = MAIN_K) -> dict:
    """batch_search for k results through the selection models/flat picks
    past K1/K2 at this B x capacity (scan_topk_verified from
    VERIFIED_MIN_BLOCK on, else scan_topk_strict; no K1/K2 launch, no strict
    fallback, recall@k = 1.0 against `truth` = (dist, kth, ids)), then the verified and the strict
    selection on the index's own tensors at this B: CUDA events and
    host-clock seconds; with peak_bound, the verified call's peak device
    memory above its inputs must stay under it."""
    from vectorindex_tpu_torch.models.flat import VERIFIED_MIN_BLOCK
    from vectorindex_tpu_torch.ops.scan import scan_topk_strict, scan_topk_verified

    path = "scan_verified" if len(q) * idx.capacity >= VERIFIED_MIN_BLOCK else "scan_strict"
    sf.reset_launches()
    res, counters = counters_of(lambda: idx.batch_search(q, k))
    calls = {k for k, v in counters.items() if k.startswith("kernel.") and k.endswith(".calls") and v}
    require(not any(sf.LAUNCHES.values()) and calls == {f"kernel.{path}.calls"}
            and counters.get("flat.verify_fallback", 0) == 0,
            f"{label}: batch_search did not take {path} alone: {counters}")
    dist, kth, ids = truth
    r_tie, r_set = recall(res, dist, kth, ids, k)
    require(r_tie == 1.0, f"{label}: recall@{k} {r_tie} < 1")
    vecs, sqn, inv, valid = idx._sync_device()
    if not idx._free and idx._next_slot >= idx.capacity:
        valid = None  # every slot live: the index passes no mask
    qt = torch.from_numpy(q).to(DEVICE)
    f = {"recall": r_tie, "set_recall": r_set, "path": path}
    for name, fn in (("verified", scan_topk_verified), ("strict", scan_topk_strict)):
        call = functools.partial(fn, qt, vecs, sqn, inv, valid, metric=idx.metric, k=k)
        f[name + "_ms"] = time_ms(call, 3, warmup=1)
        f[name + "_wall_s"] = walls(call)
    if peak_bound is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        scan_topk_verified(qt, vecs, sqn, inv, valid, metric=idx.metric, k=k)
        torch.cuda.synchronize()
        f["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        require(f["peak_mb"] <= peak_bound / 2**20,
                f"{label}: the verified scan held {f['peak_mb']:.1f} MiB > {peak_bound / 2**20:.1f}")
    log(f"api verified {label} B={len(q)}: {path}, no K1/K2 launch, no strict fallback, "
        f"recall@{k}={r_tie} (set {r_set}); scan_topk_verified {f['verified_ms']:.4g} ms "
        f"(wall {f['verified_wall_s']:.4g} s) against scan_topk_strict {f['strict_ms']:.4g} ms "
        f"(wall {f['strict_wall_s']:.4g} s)"
        + (f"; verified peak {f['peak_mb']:.1f} MiB" if "peak_mb" in f else ""))
    return f


def phase_api_verified_wide(sf, topk, api: Api, errs) -> dict:
    """Wide rows through K1/K2 and the verified route on one index: a bf16
    FlatIndex of VERIFIED_ROWS x VERIFIED_DIM seeded gaussian rows (bf16
    values, drawn on the card), every slot live. At B=8 and 64 batch_search
    runs K1/K2 on the wgmma design (no strict fallback, recall@10 = 1.0
    against f64 brute force), K1/K2 are held to their plain versions and
    the FMA design (wide_figures) and timed, and scan_topk_fused,
    scan_topk_verified and scan_topk_strict are timed on the same tensors;
    then k = 2C + 1 at B=64 takes the verified scan (verified_route: no
    K1/K2 launch, recall@k = 1.0, peak memory under its bound)."""
    from vectorindex_tpu_torch.models.flat import FlatIndex
    from vectorindex_tpu_torch.ops.scan import scan_topk_strict, scan_topk_verified
    from vectorindex_tpu_torch.ops.scoring import _BROADCAST_ELEMS
    from vectorindex_tpu_torch.utils.config import Metric

    t_phase = time.perf_counter()
    require(sf.scan_design(VERIFIED_DIM, torch.bfloat16) == "wgmma",
            f"d={VERIFIED_DIM} is not on the wgmma design")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    nq = sum(VERIFIED_BATCHES)
    data = torch.randn((VERIFIED_ROWS + nq, VERIFIED_DIM), generator=gen, device=DEVICE)
    data[VERIFIED_ROWS:] = data[:nq] + 0.1 * torch.randn((nq, VERIFIED_DIM), generator=gen,
                                                         device=DEVICE)
    data = data.bfloat16().float()
    x, queries = data[:VERIFIED_ROWS].cpu().numpy(), data[VERIFIED_ROWS:].cpu().numpy()
    idx = FlatIndex(VERIFIED_DIM, Metric.L2, capacity=VERIFIED_ROWS, storage_dtype=torch.bfloat16,
                    device=DEVICE)
    t0 = time.perf_counter()
    idx.insert_batch(list(range(VERIFIED_ROWS)), x)
    idx._sync_device()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del x
    x_dev = data[:VERIFIED_ROWS].double()
    sq_dev = (x_dev * x_dev).sum(dim=1)
    del data
    log(f"api verified wide: bf16 FlatIndex {VERIFIED_ROWS} x {VERIFIED_DIM}, capacity "
        f"{idx.capacity} ({VERIFIED_ROWS * VERIFIED_DIM * 2 / 2**30:.2f} GiB on the card), built "
        f"in {build_s:.2f} s; scan_design -> wgmma")
    vecs, sqn, inv, valid = idx._sync_device()
    figs, start = {"launches": {"bin_candidates": 0, "count_below": 0}}, 0
    for b in VERIFIED_BATCHES:
        q = queries[start : start + b]
        start += b
        res, designs, counters = search_counted(sf, idx, q)
        require(designs["fma"] == {"bin_candidates": 0, "count_below": 0}
                and all(c > 0 for c in designs["wgmma"].values()),
                f"d={VERIFIED_DIM} B={b}: K1/K2 did not run on the wgmma design: {designs}")
        calls = {k for k, v in counters.items() if k.startswith("kernel.") and k.endswith(".calls") and v}
        require(calls == {"kernel.scan_fused.calls"} and counters.get("flat.verify_fallback", 0) == 0,
                f"d={VERIFIED_DIM} B={b}: batch_search did not take K1/K2 alone: {counters}")
        for name, c in designs["wgmma"].items():
            figs["launches"][name] += c
        dist, kth, truth = brute_force(x_dev, sq_dev, q, MAIN_K)
        r_tie, r_set = recall(res, dist, kth, truth, MAIN_K)
        require(r_tie == 1.0, f"d={VERIFIED_DIM} B={b}: recall@{MAIN_K} {r_tie} < 1")
        del dist
        qt = torch.from_numpy(q).to(DEVICE)
        qk, bias, cs, _ = sf.kernel_inputs(qt, sqn, valid, Metric.L2)
        t = wide_figures(sf, topk, qk, vecs, bias, cs, errs, f"d={VERIFIED_DIM} B={b}", 5, 3)
        t["launches"] = designs["wgmma"]
        t["recall"] = r_tie
        whole = {"fused": functools.partial(sf.scan_topk_fused, qt, vecs, sqn, valid,
                                            metric=Metric.L2, k=MAIN_K),
                 "verified": functools.partial(scan_topk_verified, qt, vecs, sqn, inv, None,
                                               metric=Metric.L2, k=MAIN_K),
                 "strict": functools.partial(scan_topk_strict, qt, vecs, sqn, inv, None,
                                             metric=Metric.L2, k=MAIN_K)}
        for name, fn in whole.items():
            t[name + "_ms"] = time_ms(fn, 3, warmup=1)
        log(f"api verified wide B={b}: batch_search through K1/K2 (wgmma {designs['wgmma']}), no "
            f"strict fallback, recall@{MAIN_K}={r_tie} (set {r_set}); on the same tensors "
            f"scan_topk_fused {t['fused_ms']:.4g} ms, scan_topk_verified {t['verified_ms']:.4g} ms, "
            f"scan_topk_strict {t['strict_ms']:.4g} ms")
        figs[b] = t
    # the verified route on the same index: k past K1/K2's 2C candidates.
    # Its L2 block holds the corpus's f32 copy (ops/scoring._gram), then the
    # [B, N] distances and their temporaries, and a chunk's intermediates
    b = VERIFIED_BATCHES[-1]
    k = 2 * sf.C + 1
    q = queries[-b:]
    bound_bytes = (VERIFIED_ROWS * VERIFIED_DIM * 4 + 4 * b * VERIFIED_ROWS * 4
                   + 3 * _BROADCAST_ELEMS * 4)
    figs["large_k"] = verified_route(sf, idx, q, brute_force(x_dev, sq_dev, q, k),
                                     f"d={VERIFIED_DIM} bf16 k={k}", peak_bound=bound_bytes, k=k)
    figs["large_k"]["peak_bound_mb"] = bound_bytes / 2**20
    del idx, x_dev, sq_dev, vecs, sqn, inv, valid
    torch.cuda.empty_cache()
    api.figs["verified_wide"] = figs
    figs["phase_s"] = time.perf_counter() - t_phase
    log(f"api verified wide: phase {figs['phase_s']:.1f} s")
    return figs


def phase_api_flat(sf, topk, idx, batches, api: Api, errs) -> None:
    """On the flat main path's rows (the 1M x 128 bf16 index and its host
    rows): the verified route over a manhattan f32 index; MIPS, the rows
    augmented to padded_dim(128) = 256 in a bf16 L2 FlatIndex (K1/K2 at
    d = 256, no strict fallback), its ids equal to an inner-product
    FlatIndex's up to ties, hybrid scores equal to the virtual form's bits;
    the acceleration seam: structure, candidates at B=8 rescored exactly on
    the card, finalize_results equal to batch_search up to ties."""
    from vectorindex_tpu_torch.models import accel
    from vectorindex_tpu_torch.models.flat import FlatIndex
    from vectorindex_tpu_torch.ops import mips, scoring
    from vectorindex_tpu_torch.ops.scoring import _BROADCAST_ELEMS
    from vectorindex_tpu_torch.utils.config import Metric
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    t_phase = time.perf_counter()
    rows = idx._vectors[: idx.count]  # the f32 host mirror (bf16 values)
    small, big = batches[-1], batches[0]
    x_dev = torch.from_numpy(rows).to(DEVICE)

    # -- the verified route: manhattan over the 1M rows (f64 brute force) --
    man = FlatIndex(MAIN_DIM, Metric.MANHATTAN, device=DEVICE)
    man.insert_batch(list(range(len(rows))), rows)
    x64 = x_dev.double()
    figs = {}
    for b in VERIFIED_BATCHES:
        q = big[:b] if b > SMALL_BATCH else small
        dist = torch.cdist(torch.from_numpy(q).to(DEVICE).double(), x64, p=1)
        sd, order = torch.sort(dist, dim=1, stable=True)
        # the distance block is held twice (its chunks and their
        # concatenation); each chunk's difference and its abs are one
        # _BROADCAST_ELEMS intermediate each
        bound_bytes = 2 * b * man.capacity * 4 + 3 * _BROADCAST_ELEMS * 4
        figs[b] = verified_route(sf, man, q, (dist, sd[:, MAIN_K - 1], order[:, :MAIN_K]),
                                 f"manhattan {len(rows)} x {MAIN_DIM} f32", peak_bound=bound_bytes)
    del man, x64, dist, sd, order
    api.figs["verified_manhattan"] = figs

    # -- MIPS: explicit augmentation into a bf16 L2 index --
    dim = mips.padded_dim(MAIN_DIM)
    r2 = float(np.einsum("nd,nd->n", rows, rows).max())
    xa = mips.mips_materialize_augmentation(x_dev, r2, dim).cpu().numpy()
    mi = FlatIndex(dim, Metric.L2, storage_dtype=torch.bfloat16, device=DEVICE)
    mi.insert_batch(list(range(len(rows))), xa)
    del xa
    ip = FlatIndex(MAIN_DIM, Metric.INNER_PRODUCT, storage_dtype=torch.bfloat16, device=DEVICE)
    ip.insert_batch(list(range(len(rows))), rows)
    m = {"launches": {"bin_candidates": 0, "count_below": 0}}
    for q in (small, big):
        qa = mips.mips_augment_query(torch.from_numpy(q), dim).numpy()
        sf.reset_launches()
        res, counters = counters_of(lambda: mi.batch_search(qa, MAIN_K))
        require(counters.get("flat.verify_fallback", 0) == 0
                and counters.get("kernel.scan_fused.calls") == 1
                and all(c > 0 for c in sf.DESIGN_LAUNCHES["wgmma"].values())
                and not any(sf.LAUNCHES[name] for name in FIRST_DESIGNS),
                f"mips B={len(q)}: K1/K2 (wgmma design) did not run alone: {counters}, "
                f"{sf.DESIGN_LAUNCHES}, {sf.LAUNCHES}")
        for name in m["launches"]:
            m["launches"][name] += sf.LAUNCHES[name]
        api.count("mips", sf, ("bin_candidates", "count_below"))
        want = ip.batch_search(q, MAIN_K + 1)
        wd = -np.array([[r.score for r in row] for row in want], dtype=np.float64)
        require(ids_match_up_to_ties(rows_ids(res), rows_ids(want), wd, MAIN_K),
                f"mips B={len(q)}: ids differ from the inner-product index's")
    # K1/K2 at d = 256 on the MIPS index's tensors, against their plain versions
    x, sqn, _, valid = mi._sync_device()
    qk, bias, cs, _ = sf.kernel_inputs(
        mips.mips_augment_query(torch.from_numpy(big), dim).to(DEVICE), sqn, valid, Metric.L2)
    k1, k2, tau = check_against_plain(sf, topk, qk, x, bias, cs, Metric.L2)
    errs["bin_candidates"] = max(errs["bin_candidates"], k1)
    errs["count_below"] = max(errs["count_below"], k2)
    mt = design_turns(sf, qk, x, bias, cs, tau, Metric.L2, 10, 5)
    for name in ("bin_candidates", "count_below"):
        m[name + "_ms"], m[name + "_device_ms"] = mt[name], mt[name + "_dev"]
        m[name + "_first_design_ms"] = mt[name + "_v1"]
        m[name + "_first_design_device_ms"] = mt[name + "_v1_dev"]
    for name in ("bin_candidates", "count_below"):
        m[name + "_bound"] = flat_bound(x.shape[0], dim, len(big), 2, name)
    # the band (d = 256) past one query tile: the route's tiles against the
    # narrow tile's plan, bit for bit and in turns; cuBLAS's bf16 q x^T beside
    m["narrow"] = plan_turns(sf, qk, x, bias, cs, tau, Metric.L2, 10, 5)
    qb = qk.to(x.dtype)
    m["cublas_product_ms"] = time_ms(lambda: torch.matmul(qb, x.T), 10)
    q8 = torch.from_numpy(small).to(DEVICE)
    hybrid = mips.mips_hybrid_score_block(q8, x_dev, r2)
    virtual = mips.mips_virtual_to_l2_scores(scoring.inner_product_block(q8, x_dev),
                                             scoring.squared_norms(q8), r2)
    require(torch.equal(hybrid, virtual), "mips: hybrid scores differ from the virtual form's")
    explicit = scoring.distance_block(mips.mips_augment_query(q8, dim),
                                      mips.mips_materialize_augmentation(x_dev, r2, dim), Metric.L2)
    require(torch.allclose(hybrid, explicit, rtol=2e-4, atol=2e-3),
            "mips: hybrid scores differ from the explicit augmentation's")
    del mi, ip, x, sqn, valid, qk, bias, hybrid, virtual, explicit
    api.figs["mips"] = m
    log(f"api mips: {len(rows)} x {MAIN_DIM} -> {dim} (R^2 {r2:.4g}) bf16 L2 FlatIndex: K1/K2 launches "
        f"{m['launches']} at B={SMALL_BATCH} and {MAIN_BATCH}, no strict fallback, ids equal the "
        f"inner-product index's up to ties; K1/K2 within the tensor-core rule of their plain "
        f"versions at d={dim} (K1 max_abs_err {k1:.3g}, K2 count diff {k2}); B={MAIN_BATCH} K1 "
        f"{m['bin_candidates_ms']:.4g} ms (bound {m['bin_candidates_bound'][0]:.4g}), K2 "
        f"{m['count_below_ms']:.4g} ms (bound {m['count_below_bound'][0]:.4g}); in turns with the "
        f"first design: {design_log(mt)}; {plan_log(m['narrow'])}; cuBLAS q x^T alone "
        f"{m['cublas_product_ms']:.4g} ms; hybrid == virtual "
        f"bit for bit, within 2e-4 of the explicit augmentation")

    # -- the acceleration seam on the flat index --
    st = accel.get_index_structure(idx)
    require((st.count, st.dimension, st.metric) == (idx.count, MAIN_DIM, "l2"), "accel flat structure")
    cands = accel.get_batch_candidates(idx, small)
    xc = torch.from_numpy(cands[0].vectors).to(DEVICE).double()
    q64 = torch.from_numpy(small).to(DEVICE).double()
    exact = ((q64 * q64).sum(1, keepdim=True) - 2.0 * q64 @ xc.T + (xc * xc).sum(1)[None]).cpu().numpy()
    sf.reset_launches()
    native = idx.batch_search(small, MAIN_K)
    require(all(c > 0 for c in sf.DESIGN_LAUNCHES["wgmma"].values())
            and not any(sf.LAUNCHES[name] for name in FIRST_DESIGNS),
            f"accel flat: K1/K2 not on the wgmma design: {sf.DESIGN_LAUNCHES}, {sf.LAUNCHES}")
    api.count("accel", sf, ("bin_candidates", "count_below"))
    got = [accel.finalize_results(idx, c.internal_ids, exact[b], MAIN_K) for b, c in enumerate(cands)]
    ref = np.sort(exact, axis=1)[:, : MAIN_K + 1]
    require(ids_match_up_to_ties(rows_ids(got), rows_ids(native), ref, MAIN_K),
            "accel flat: finalize_results differs from batch_search")
    del x_dev, xc, cands, exact
    torch.cuda.empty_cache()
    log(f"api accel flat: structure {st}, B={SMALL_BATCH} candidates ({len(rows)} rows each) "
        f"rescored in f64 on the card; finalize_results equals batch_search up to ties; phase_api "
        f"flat {time.perf_counter() - t_phase:.1f} s")


def phase_sharded_flat(idx, batches, api: Api) -> None:
    """ShardedFlatIndex over the flat main path's rows on two meshes: the
    visible cards and SHARDS_ON_ONE_CARD shards of the first card; at B=8 and
    B=256 both give equal bits, and ids equal to the unsharded index's up to
    ties. Then where a sharded search's time goes at B=256: the shards'
    scoring and per-block top-k against the gather and merge."""
    from vectorindex_tpu_torch.models.sharded import ShardedFlatIndex
    from vectorindex_tpu_torch.ops import scoring
    from vectorindex_tpu_torch.ops.topk import topk_padded
    from vectorindex_tpu_torch.parallel import make_mesh, sharded_search as ss
    from vectorindex_tpu_torch.utils.config import Metric
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    t_phase = time.perf_counter()
    rows = idx._vectors[: idx.count]
    small, big = batches[-1], batches[0]
    cards = make_mesh() if DEVICE == "cuda" else make_mesh(devices=[DEVICE])
    meshes = {"cards": cards, "one card": card_mesh(SHARDS_ON_ONE_CARD)}
    out, f = {}, {}
    for name, mesh in meshes.items():
        sh = ShardedFlatIndex(MAIN_DIM, Metric.L2, storage_dtype=torch.bfloat16,
                              devices=list(mesh.devices.flat))
        sh.insert_batch(list(range(len(rows))), rows)
        out[name] = {len(q): sh.batch_search(q, MAIN_K) for q in (small, big)}
        for q in (small, big):
            f[f"{name} B={len(q)} wall_s"] = walls(lambda: sh.batch_search(q, MAIN_K))
            log(f"sharded flat wall: {name} ({mesh.size} shards) B={len(q)} "
                f"{f[f'{name} B={len(q)} wall_s']:.4g} s")
        if name == "one card":
            vecs, sqn, _, valid = sh._sync_device()
            qt = torch.from_numpy(big).to(DEVICE)
            f["search_ms"] = time_ms(lambda: ss.sharded_flat_search(
                mesh, qt, vecs, valid, MAIN_K, Metric.L2, x_sqnorms=sqn), 3, warmup=1)
            parts = [ss._shard_topk(qt, vecs.shards[s], valid.shards[s], sqn.shards[s], None,
                                    Metric.L2, MAIN_K, s * vecs.shards[0].shape[0])
                     for s in range(mesh.size)]
            f["shards_ms"] = time_ms(lambda: [ss._shard_topk(
                qt, vecs.shards[s], valid.shards[s], sqn.shards[s], None, Metric.L2, MAIN_K,
                s * vecs.shards[0].shape[0]) for s in range(mesh.size)], 3, warmup=1)
            f["merge_ms"] = time_ms(lambda: ss.gather_merge(parts, mesh.first, MAIN_K), 10)
            nb = min(ss.SCAN_BLOCK, vecs.shards[0].shape[0])
            blk = vecs.shards[0][:nb]
            norms = scoring.NormCache(sq=sqn.shards[0][:nb])
            d = scoring.distance_block(qt, blk, Metric.L2, norms=norms)
            ok = valid.shards[0][:nb][None, :]
            ids = torch.arange(nb, dtype=torch.int32, device=DEVICE)[None, :]
            f["block_score_ms"] = time_ms(
                lambda: scoring.distance_block(qt, blk, Metric.L2, norms=norms), 10)
            f["block_topk_ms"] = time_ms(
                lambda: topk_padded(d, ok, MAIN_K, ids=ids, strict_ties=False), 10)
            f["blocks"], f["block_rows"] = sum(-(-t.shape[0] // nb) for t in vecs.shards), nb
            del vecs, sqn, valid, parts, d, blk, norms, ok
        del sh
        torch.cuda.empty_cache()
    for q in (small, big):
        a, b = out["cards"][len(q)], out["one card"][len(q)]
        require([[(r.id, r.score) for r in row] for row in a] == [[(r.id, r.score) for r in row]
                                                                  for row in b],
                f"sharded flat B={len(q)}: the two meshes differ")
        want = idx.batch_search(q, MAIN_K + 1)
        wd = np.array([[r.score for r in row] for row in want], dtype=np.float64) ** 2
        require(ids_match_up_to_ties(rows_ids(a), rows_ids(want), wd, MAIN_K),
                f"sharded flat B={len(q)}: ids differ from the unsharded index's")
    api.figs["sharded_flat"] = f
    log(f"sharded flat: ShardedFlatIndex {len(rows)} x {MAIN_DIM} bf16 over {meshes['cards'].size} visible "
        f"card(s) and {SHARDS_ON_ONE_CARD} shards of cuda:0: equal bits at B={SMALL_BATCH} and "
        f"{MAIN_BATCH}, ids equal the unsharded index's up to ties; "
        f"B={MAIN_BATCH} on {SHARDS_ON_ONE_CARD} shards: search {f['search_ms']:.4g} ms = "
        f"shards {f['shards_ms']:.4g} ({f['blocks']} blocks of {f['block_rows']} rows: score "
        f"{f['block_score_ms']:.4g} + top-k {f['block_topk_ms']:.4g} each) + gather and merge "
        f"{f['merge_ms']:.4g} ms; phase {time.perf_counter() - t_phase:.1f} s")


def phase_api_ivf(kp, idx, batches, api: Api) -> None:
    """The acceleration seam on the IVF 1M index: structure, the probed
    candidates of a B=8 batch rescored exactly on the card, finalize_results
    equal to the exact search of the probed lists and to batch_search (K3)
    up to ties."""
    from vectorindex_tpu_torch.models import accel
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    t0 = time.perf_counter()
    q = batches[0]
    st = accel.get_index_structure(idx)
    require(st.trained and st.centroids.shape == (IVF_NLIST, IVF_DIM)
            and int(st.list_lengths.sum()) == idx.count, "accel ivf structure")
    cands = accel.get_batch_candidates(idx, q)
    got = []
    for b, c in enumerate(cands):
        xc = torch.from_numpy(c.vectors).to(DEVICE).double()
        qb = torch.from_numpy(q[b]).to(DEVICE).double()
        d = ((xc - qb) ** 2).sum(1).cpu().numpy()
        got.append(accel.finalize_results(idx, c.internal_ids, d, MAIN_K))
    rd, ri = ivf_reference(idx, q, MAIN_K, idx.config.nprobe)
    require(ids_match_up_to_ties(rows_ids(got), ri, rd, MAIN_K),
            "accel ivf: finalize_results differs from the probed-list search")
    kp.reset_launches()
    native = idx.batch_search(q, MAIN_K)
    require(kp.LAUNCHES["ivf_probe_topc"] == 1, f"accel ivf: batch_search did not run K3: {kp.LAUNCHES}")
    api.count("accel", kp, ("ivf_probe_topc",))
    require(ids_match_up_to_ties(rows_ids(got), rows_ids(native), rd, MAIN_K),
            "accel ivf: finalize_results differs from batch_search")
    log(f"api accel ivf: structure (nlist {st.nlist}, nprobe {st.nprobe}, "
        f"{int(st.list_lengths.sum())} rows); B={SMALL_BATCH} candidates "
        f"{[c.count for c in cands]} rescored in f64; finalize_results equals the probed-list "
        f"search and batch_search (K3) up to ties; {time.perf_counter() - t0:.1f} s")


def phase_sharded_ivf(idx, batches, bigq, api: Api) -> None:
    """partition_store of the IVF 1M index's lists over SHARDS_ON_ONE_CARD
    shards of the first card, sharded_ivf_search at B=8 and B=256: ids equal
    the exact search of the probed lists up to ties."""
    from vectorindex_tpu_torch.ops import ivf as tivf
    from vectorindex_tpu_torch.parallel import partition_store, sharded_ivf_search
    from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

    t0 = time.perf_counter()
    mesh = card_mesh(SHARDS_ON_ONE_CARD)
    arrays = partition_store(idx._store, mesh)
    rows = [int(t.sum()) for t in arrays.lengths]
    cap = tivf.probe_cap_for(idx._store.max_length)
    f = {"partition_s": time.perf_counter() - t0, "rows_per_shard": rows}
    for q in (batches[0], bigq):
        search = functools.partial(sharded_ivf_search, mesh, torch.from_numpy(q).to(DEVICE),
                                   idx._centroids_dev, arrays, nprobe=IVF_NPROBE, probe_cap=cap,
                                   k=MAIN_K)
        d, i = search()
        rd, ri = ivf_reference(idx, q, MAIN_K, IVF_NPROBE)
        require(ids_match_up_to_ties(i.cpu().numpy(), ri, rd, MAIN_K),
                f"sharded ivf B={len(q)}: ids differ from the probed-list search")
        require(np.allclose(d.cpu().numpy(), rd[:, :MAIN_K], rtol=RTOL, atol=ATOL),
                f"sharded ivf B={len(q)}: distances differ")
        f[f"B={len(q)} ms"] = time_ms(search, 3, warmup=1)
    del arrays
    torch.cuda.empty_cache()
    api.figs["sharded_ivf"] = f
    log(f"sharded ivf: partition_store over {SHARDS_ON_ONE_CARD} shards of cuda:0 "
        f"({f['partition_s']:.2f} s; rows a shard {rows}), sharded_ivf_search at nprobe "
        f"{IVF_NPROBE} equal to the probed-list search up to ties at B={SMALL_BATCH} and "
        f"{IVF_BIG_BATCH}; " + ", ".join(f"{k} {v:.4g}" for k, v in f.items() if k.endswith("ms"))
        + f" ms; {time.perf_counter() - t0:.1f} s")


def phase_sharded_pq(idx, evalq, truth, api: Api) -> None:
    """sharded_ivf_pq_search over the pq16 index's lists and codes on
    SHARDS_ON_ONE_CARD shards of the first card (each shard reranks its own
    ADC top-512 exactly), nprobe 32: recall@10 >= SHARDED_PQ_RECALL_MIN."""
    from vectorindex_tpu_torch.ops import ivf as tivf
    from vectorindex_tpu_torch.parallel import partition_store, sharded_ivf_pq_search

    t0 = time.perf_counter()
    mesh = card_mesh(SHARDS_ON_ONE_CARD)
    _, codes, _ = idx._sync_pq()
    arrays = partition_store(idx._store, mesh, codes=codes)
    search = functools.partial(
        sharded_ivf_pq_search, mesh, centroids=idx._centroids_dev, arrays=arrays, books=idx._books,
        nprobe=PQ_NPROBE, probe_cap=tivf.probe_cap_for(idx._store.max_length), k=MAIN_K,
        rerank_c=PQ_RERANK_C, packed_u4=idx.config.ks <= 16)
    ids = [search(q=torch.from_numpy(evalq[s : s + SMALL_BATCH]).to(DEVICE))[1]
           for s in range(0, len(evalq), SMALL_BATCH)]
    dist, kth, truth_ids = truth
    r_tie, r_set = recall_ids(torch.cat(ids), dist, kth, truth_ids, MAIN_K)
    q8 = torch.from_numpy(evalq[:SMALL_BATCH]).to(DEVICE)
    ms = time_ms(lambda: search(q=q8), 3, warmup=1)
    del arrays
    torch.cuda.empty_cache()
    require(r_tie >= SHARDED_PQ_RECALL_MIN,
            f"sharded ivf-pq recall@{MAIN_K} {r_tie} < {SHARDED_PQ_RECALL_MIN}")
    api.figs["sharded_pq"] = {"recall": r_tie, "b8_ms": ms}
    log(f"sharded ivf-pq: pq16 over {SHARDS_ON_ONE_CARD} shards of cuda:0, nprobe {PQ_NPROBE}, "
        f"per-shard rerank of {PQ_RERANK_C}: recall@{MAIN_K}={r_tie} (set {r_set}) over "
        f"{len(evalq)} queries; B={SMALL_BATCH} {ms:.4g} ms; {time.perf_counter() - t0:.1f} s")


def phase_api_hnsw(idx, q: np.ndarray, api: Api) -> None:
    """The acceleration seam on the HNSW 100k index: structure, candidates
    at B=8 (the ef_search beam) rescored exactly on the card,
    finalize_results equal to batch_search up to ties."""
    from vectorindex_tpu_torch.models import accel
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    t0 = time.perf_counter()
    st = accel.get_index_structure(idx)
    require(st.max_level == len(idx._layers) - 1 and st.entry_point == idx._entry
            and st.levels[0]["neighbors"].shape[0] == idx._layers[0].count, "accel hnsw structure")
    cands = accel.get_batch_candidates(idx, q)
    got, ref = [], []
    for b, c in enumerate(cands):
        xc = torch.from_numpy(c.vectors).to(DEVICE).double()
        d = ((xc - torch.from_numpy(q[b]).to(DEVICE).double()) ** 2).sum(1).cpu().numpy()
        got.append(accel.finalize_results(idx, c.internal_ids, d, MAIN_K))
        ref.append(np.sort(d)[: MAIN_K + 1])
    native = idx.batch_search(q, MAIN_K)
    require(ids_match_up_to_ties(rows_ids(got), rows_ids(native), np.stack(ref), MAIN_K),
            "accel hnsw: finalize_results differs from batch_search")
    log(f"api accel hnsw: structure (levels {len(st.levels)}, entry {st.entry_point}, m {st.m}); "
        f"B={len(q)} candidates {[c.count for c in cands]} rescored in f64; finalize_results "
        f"equals batch_search up to ties; {time.perf_counter() - t0:.1f} s")


def phase_sharded_hnsw(x: np.ndarray, W: np.ndarray, q: np.ndarray, x_dev, sq_dev, ps,
                       api: Api) -> None:
    """ShardedHNSWIndex over the HNSW main path's rows on SHARDS_ON_ONE_CARD
    shards of the first card at HNSWConfig() (efS 64): recall@10 >=
    HNSW_RECALL_MIN at B=256; save / load_index gives equal ids and scores;
    then SHARDED_HNSW_TAIL inserts (the tail buffer: no rebuild) and 1%
    removed: none returned, recall over the live rows still >=
    HNSW_RECALL_MIN."""
    from vectorindex_tpu_torch.models import load_index
    from vectorindex_tpu_torch.models.hnsw import HNSWConfig
    from vectorindex_tpu_torch.models.sharded import ShardedHNSWIndex
    from vectorindex_tpu_torch.utils.config import Metric

    t_phase = time.perf_counter()
    k = MAIN_K
    idx = ShardedHNSWIndex(HNSW_DIM, Metric.L2, HNSWConfig(**HNSW_SHARDED_CONFIG),
                           devices=list(card_mesh(SHARDS_ON_ONE_CARD).devices.flat))
    idx.insert_batch(list(range(len(x))), x)
    t0 = time.perf_counter()
    idx.statistics()  # the bulk build
    torch.cuda.synchronize()
    f = {"build_s": time.perf_counter() - t0}
    res = idx.batch_search(q, k)
    dist, kth, truth = brute_force(x_dev, sq_dev, q, k)
    f["recall"] = recall(res, dist, kth, truth, k)[0]
    require(f["recall"] >= HNSW_RECALL_MIN, f"sharded hnsw recall@{k} {f['recall']} < {HNSW_RECALL_MIN}")
    f["b256_wall_s"] = walls(lambda: idx.batch_search(q, k))
    path = ps.path("sharded_hnsw.json")
    t0 = time.perf_counter()
    idx.save(path)
    loaded = load_index(path, device=DEVICE)
    got = loaded.batch_search(q, k)
    f["reload_s"] = time.perf_counter() - t0
    require(type(loaded) is ShardedHNSWIndex and loaded.n_shards == SHARDS_ON_ONE_CARD,
            "load_index of a sharded_hnsw snapshot")
    same_rows(got, res, f"sharded hnsw B={len(q)}")
    del loaded
    os.remove(path)

    rng = np.random.default_rng(HNSW_SEED + 2)
    tail = rng.standard_normal((SHARDED_HNSW_TAIL, W.shape[0]), dtype=np.float32) @ W
    tail += 0.05 * rng.standard_normal(tail.shape, dtype=np.float32)
    tail /= np.linalg.norm(tail, axis=1, keepdims=True)
    built = idx._built_rows
    idx.insert_batch(list(range(len(x), len(x) + len(tail))), tail)
    removed = rng.choice(len(x), int(HNSW_REMOVE_FRAC * len(x)), replace=False)
    for i in removed.tolist():
        idx.remove(i)
    qt = np.concatenate([q[: len(q) - SMALL_BATCH], tail[:SMALL_BATCH]])  # tail rows find themselves
    res = idx.batch_search(qt, k)
    require(idx._built_rows == built, "sharded hnsw: the tail rebuilt a shard")
    require([row[0].id for row in res[-SMALL_BATCH:]] == list(range(len(x), len(x) + SMALL_BATCH)),
            "sharded hnsw: a tail row did not find itself")
    alive = np.ones(len(x) + len(tail), dtype=bool)
    alive[removed] = False
    require(all(alive[r.id] for row in res for r in row), "sharded hnsw: a removed id was returned")
    x_all = torch.cat([x_dev, torch.from_numpy(tail).to(DEVICE)])
    dist, kth, truth = masked_truth(x_all, (x_all * x_all).sum(dim=1), qt, k, alive)
    f["tail_recall"] = recall(res, dist, kth, truth, k)[0]
    require(f["tail_recall"] >= HNSW_RECALL_MIN,
            f"sharded hnsw recall after the tail and removals {f['tail_recall']} < {HNSW_RECALL_MIN}")
    del idx, x_all, dist
    torch.cuda.empty_cache()
    api.figs["sharded_hnsw"] = f
    log(f"sharded hnsw: {len(x)} x {HNSW_DIM} over {SHARDS_ON_ONE_CARD} shards of cuda:0 "
        f"(HNSWConfig() defaults): build {f['build_s']:.2f} s, recall@{k} {f['recall']} at B="
        f"{len(q)} (wall {f['b256_wall_s']:.4g} s); save + load_index + first search "
        f"{f['reload_s']:.2f} s, equal ids and scores; {SHARDED_HNSW_TAIL} tail inserts (no "
        f"rebuild, each found first) and {removed.size} removed (none returned): recall@{k} "
        f"{f['tail_recall']}; phase {time.perf_counter() - t_phase:.1f} s")


def api_summary(api: Api, gpu: str) -> str:
    """One line: phase_api's and phase_sharded's seconds (each part's and
    their sums), the verified route against the strict path (events ms)
    and the parts' kernel launches."""
    parts = [f"phase_{kind} {sum(v for k, v in api.seconds.items() if k.startswith(kind)):.1f} s ("
             + ", ".join(f"{k[len(kind) + 1:]} {v:.1f}" for k, v in api.seconds.items()
                         if k.startswith(kind)) + ")" for kind in ("api", "sharded")]
    wide = api.figs.get("verified_wide", {})
    for b in VERIFIED_BATCHES:
        if b in wide:
            f = wide[b]
            parts.append(f"verified_wide B={b} (scan_fused) fused {f['fused_ms']:.4g} ms / verified "
                         f"{f['verified_ms']:.4g} ms / strict {f['strict_ms']:.4g} ms")
    if "large_k" in wide:
        f = wide["large_k"]
        parts.append(f"verified_wide k={2 * 256 + 1} B={VERIFIED_BATCHES[-1]} ({f['path']}) "
                     f"verified {f['verified_ms']:.4g} ms / strict {f['strict_ms']:.4g} ms, peak "
                     f"{f['peak_mb']:.1f} MiB (bound {f['peak_bound_mb']:.1f})")
    for b, f in api.figs.get("verified_manhattan", {}).items():
        parts.append(f"verified_manhattan B={b} ({f['path']}) verified {f['verified_ms']:.4g} ms / "
                     f"strict {f['strict_ms']:.4g} ms")
    return f"api: gpu {gpu}; " + "; ".join(parts) + f"; launches {api.launches}"


# ---------------------------------------------------------------------------
# phase_bench: the port's benchmark CLI (python -m vectorindex_tpu_torch.bench)
# ---------------------------------------------------------------------------

#: the CLI at SIFT1M's shape: the flat, IVF (nlist=1024, nprobe=32) and IVF-PQ
#: (pq16) suites over datagen.generate's 1M x 128 unit rows, 256 queries in
#: one batch of 256 (K1/K2 on the f32 FMA design, K4, K9); the nprobe sweep
#: over generate_clustered's rows; the microbench at B=256 over 20 query
#: slices; the `-m` entry point with no --device at 131,072 rows, 64 queries
BENCH_ROWS, BENCH_DIM, BENCH_QUERIES, BENCH_NLIST, BENCH_NPROBE, BENCH_PQ_M = (
    1_000_000, 128, 256, 1024, 32, 16)
BENCH_SWEEP, BENCH_MICRO_TRIALS, BENCH_SUB_ROWS, BENCH_SUB_QUERIES = "nprobe=8,32", 20, 131_072, 64
#: the kernels each suite of the CLI must launch
BENCH_KERNELS = {"bin_candidates": "flat", "count_below": "flat", "ivf_probe_scores": "ivf",
                 "adc_probe_scores": "ivfpq"}


def kernel_modules():
    from vectorindex_tpu_torch.kernels import adc, adc_probe, ivf_probe, scan_fused

    return scan_fused, ivf_probe, adc_probe, adc


def all_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    out = {}
    for mod in kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def launches_of(fn):
    """(fn(), every kernel's launches in the call), the counts set to 0
    just before and read just after."""
    for mod in kernel_modules():
        mod.reset_launches()
    out = fn()
    return out, all_launches()


@contextlib.contextmanager
def bench_capture(cli, harness):
    """While inside, record what the CLI's suites pass through the harness:
    each suite's index by name, and in call order each suite's corpus and
    queries (brute_force_topk's arguments), truth and results (recall_at_k's)."""
    seen = {"index": {}, "truth_args": [], "truth": [], "results": []}
    saved = cli.bench_index, harness.brute_force_topk, harness.recall_at_k

    def bench_index(make_index, name, *a, **kw):
        def made():
            seen["index"][name] = make_index()
            return seen["index"][name]
        return saved[0](made, name, *a, **kw)

    def brute_force_topk(x, q, *a, **kw):
        seen["truth_args"].append((x, q))
        return saved[1](x, q, *a, **kw)

    def recall_at_k(results, truth, *a, **kw):
        seen["results"].append(results)
        seen["truth"].append(truth)
        return saved[2](results, truth, *a, **kw)

    cli.bench_index, harness.brute_force_topk, harness.recall_at_k = (
        bench_index, brute_force_topk, recall_at_k)
    try:
        yield seen
    finally:
        cli.bench_index, harness.brute_force_topk, harness.recall_at_k = saved


def check_bench_flat(sf, topk, seen, payload, errs) -> dict:
    """The flat suite's results at the tie rule of PERF.md §2 against an
    independent brute force (recall 1.0; the harness's truth equal to it up
    to ties), then K1/K2 on the suite's own f32 index and queries: against
    their plain versions (bit for bit on f32), timed, with their bounds."""
    from vectorindex_tpu_torch.utils.config import Metric
    from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

    x, q = seen["truth_args"][0]
    x_dev = torch.from_numpy(x).to(DEVICE)
    sq_dev = (x_dev * x_dev).sum(dim=1)
    dist, kth, truth = brute_force(x_dev, sq_dev, q, MAIN_K)
    got = torch.tensor([[int(r.id[1:]) for r in row] for row in seen["results"][0]],
                       device=dist.device)
    r_tie, r_set = recall_ids(got, dist, kth, truth, MAIN_K)
    sd = torch.sort(dist, dim=1, stable=True)[0][:, : MAIN_K + 1].cpu().numpy()
    require(ids_match_up_to_ties(seen["truth"][0], truth.cpu().numpy(), sd, MAIN_K),
            "bench: the harness's truth differs from the brute force beyond ties")
    misses = int(round((1.0 - payload[0]["recall_avg"]) * len(q) * MAIN_K))
    require(r_tie == 1.0, f"bench flat: recall@{MAIN_K} {r_tie} < 1 under the tie rule")
    log(f"bench flat: recall@{MAIN_K} {r_tie} under the tie rule (set recall {r_set}; the "
        f"harness's recall_avg {payload[0]['recall_avg']}, {misses} misses, each a tie of the "
        "truth's k-th distance)")
    del x_dev, sq_dev, dist

    idx = seen["index"]["flat"]
    xk, sqn, _, valid = idx._sync_device()
    require(xk.dtype == torch.float32 and sf.scan_design(xk.shape[1], xk.dtype) == "fma",
            "bench flat: the f32 index does not take the FMA design")
    out = {"recall_tie": r_tie, "recall_set": r_set, "misses": misses}
    qd = torch.from_numpy(q).to(DEVICE)
    for b in (len(q), SMALL_BATCH):  # the suite's batch, and a serving batch of its queries
        qk, bias, cs, _ = sf.kernel_inputs(qd[:b], sqn, valid, Metric.L2)
        k1, k2, tau = check_against_plain(sf, topk, qk, xk, bias, cs, Metric.L2)
        errs["bin_candidates"] = max(errs["bin_candidates"], k1)
        errs["count_below"] = max(errs["count_below"], k2)
        args = (qk, xk, bias, cs)
        t = design_turns(sf, qk, xk, bias, cs, tau, Metric.L2, 10, 5)
        t["bin_candidates_plain"] = time_ms(lambda: sf.bin_candidates_ref(*args, metric=Metric.L2), 3)
        t["count_below_plain"] = time_ms(lambda: sf.count_below_ref(*args, tau, metric=Metric.L2), 3)
        for name in ("bin_candidates", "count_below"):
            t[name + "_bound"] = flat_bound(xk.shape[0], xk.shape[1], b, 4, name)
        log(f"bench flat: K1/K2 on the f32 FMA design (B={b}, n={xk.shape[0]}, d={xk.shape[1]}) "
            f"equal to their plain versions and their first design bit for bit (K1 max_abs_err "
            f"{k1:.3g}, K2 count diff {k2}); {design_log(t)}; plain {t['bin_candidates_plain']:.4g} / "
            f"{t['count_below_plain']:.4g} ms; bound {t['bin_candidates_bound'][0]:.4g} / "
            f"{t['count_below_bound'][0]:.4g} ms ({t['bin_candidates_bound'][1]})")
        out[b] = t
    out["split"] = flat_wall_split(idx, q)
    s = out["split"]
    log(f"bench flat: one batch_search of B={len(q)} over the suite's index: wall {s['wall_ms']:.4g} "
        f"ms (median of 5) = K1 {s['k1_ms']:.4g} (scan and split merge) + K2 {s['k2_ms']:.4g} + "
        f"other device {s['other_device_ms']:.4g} ({s['other_launches']:.0f} launches) + host "
        f"{s['host_ms']:.4g} ms (the wall less the device's busy time; device times by the profiler, "
        f"a search's mean over the {s['searches_recorded']} of 5 it recorded)")
    return out


#: the FMA-design kernel's mode (0: K1, 2: K2) in its profiler name,
#: demangled ("scan_fma_kernel<float, 0, 0, 8, 8>") or mangled
FMA_MODE_RE = re.compile(
    r"scan_fma_kernel(?:<[^,>]*, *\d+, *(\d+)|I(?:f|13__nv_bfloat16)Li\d+ELi(\d+)E)")


def flat_wall_split(idx, q: np.ndarray, calls: int = 5, tries: int = 3) -> dict:
    """A warm batch_search of q on a flat f32 index: its wall (host clock,
    synchronised; median of `calls`) split into K1 (the FMA scan and its
    split merge), K2, the other device work (the profiler's device time over
    `calls` calls, divided by the K1 scans it recorded: a search launches
    one, and a session may miss a call's kernels; a session that records
    none is repeated, up to `tries`) and the host (the wall less the
    device's busy time: issue and Python)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx.batch_search(q, MAIN_K)
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        idx.batch_search(q, MAIN_K)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = float(np.median(walls))
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                idx.batch_search(q, MAIN_K)
            torch.cuda.synchronize()
        k1 = k2 = other = 0.0
        searches = launches = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
                continue
            ms = e.self_device_time_total / 1e3
            m = FMA_MODE_RE.search(e.key)
            mode = m and (m.group(1) or m.group(2))
            if mode == "0":
                k1 += ms
                searches += e.count
            elif "merge_splits_kernel" in e.key:
                k1 += ms
            elif mode:
                k2 += ms
            else:
                other += ms
                launches += e.count
        if searches and k2 > 0:
            break
    require(searches and k2 > 0, "bench flat: the profiler shows no FMA-design K1/K2 kernel in "
            f"batch_search: {[e.key[:80] for e in prof.key_averages()][:20]}")
    k1, k2, other = k1 / searches, k2 / searches, other / searches
    return {"wall_ms": wall, "k1_ms": k1, "k2_ms": k2, "other_device_ms": other,
            "other_launches": launches / searches, "searches_recorded": searches,
            "host_ms": wall - (k1 + k2 + other)}


def check_bench_probes(kp, ap, seen) -> None:
    """The IVF and IVF-PQ suites' own indices searched again at their
    queries, through K4 / K9 and through the kernels' plain versions: the
    same results (the kernels equal their plain versions bit for bit)."""
    for i, (name, module, kernel) in enumerate(
            (("ivf", kp, "ivf_probe_scores"), ("ivfpq", ap, "adc_probe_scores")), start=1):
        idx, q = seen["index"][name], seen["truth_args"][i][1]
        got = idx.batch_search(q, MAIN_K)
        with plain_versions(module, [kernel]):
            want = idx.batch_search(q, MAIN_K)
        same_results(got, want, MAIN_K, f"bench {name}")
        log(f"bench {name}: B={len(q)} through {kernel} equal to the search through its plain "
            "version")


def phase_bench(sf, kp, ap, topk, gpu: str, errs) -> dict:
    """The port's benchmark CLI on the card: (a) main() over the flat, IVF
    and IVF-PQ suites at 1M x 128 in this process (K1, K2, K4, K9 launched;
    every BenchResult field present and finite; flat recall 1.0 under the
    tie rule), (b) the nprobe sweep (recall does not fall as nprobe rises),
    (c) the microbench beside its byte bound, (d) `python -m
    vectorindex_tpu_torch.bench` with no --device in a subprocess (exit 0,
    its envelope names the card)."""
    from vectorindex_tpu_torch.bench import __main__ as cli
    from vectorindex_tpu_torch.bench import harness
    from vectorindex_tpu_torch.utils.telemetry import TELEM

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "bench")
    os.makedirs(out_dir, exist_ok=True)
    shape = ["--n", str(BENCH_ROWS), "--d", str(BENCH_DIM), "--k", str(MAIN_K),
             "--queries", str(BENCH_QUERIES), "--ivf-nlist", str(BENCH_NLIST), "--device", DEVICE]
    figs = {}

    # (a) the suites, in process
    path = os.path.join(out_dir, "suites.json")
    with bench_capture(cli, harness) as seen:
        TELEM.reset()
        TELEM.enable()
        t0 = time.perf_counter()
        try:
            payload, launches = launches_of(lambda: cli.main(
                [*shape, "--index", "flat,ivf,ivfpq", "--batch", str(BENCH_QUERIES),
                 "--ivf-nprobe", str(BENCH_NPROBE), "--pq-m", str(BENCH_PQ_M), "--out", path]))
        finally:
            TELEM.disable()
        figs["suites_s"] = time.perf_counter() - t0
        designs = {d: dict(c) for d, c in sf.DESIGN_LAUNCHES.items()}
        for name, suite in BENCH_KERNELS.items():
            require(launches[name] > 0, f"bench {suite}: {name} was not launched: {launches}")
        require(designs["wgmma"]["bin_candidates"] == 0 and designs["fma"]["bin_candidates"] > 0,
                f"bench flat: K1/K2 did not run on the f32 FMA design: {designs}")
        fields = [f.name for f in dataclasses.fields(harness.BenchResult)]
        require([r["index"] for r in payload] == ["flat", "ivf", "ivfpq"]
                and all(list(r) == fields for r in payload), f"bench: malformed suites {payload}")
        for r in payload:
            nums = [v for key, v in r.items() if key not in ("index", "metric", "params")]
            require(all(np.isfinite(v) for v in [*nums, *r["params"].values()]),
                    f"bench {r['index']}: a field is not finite: {r}")
        with open(path) as f:
            require(json.load(f) == payload, "bench: --out holds another payload")
        figs["fallback"] = TELEM.snapshot()["counters"].get("flat.verify_fallback", 0)
        figs["flat"] = check_bench_flat(sf, topk, seen, payload, errs)
        check_bench_probes(kp, ap, seen)
        del seen
    figs["suites"] = payload
    figs["launches"] = launches
    torch.cuda.empty_cache()
    log(f"bench suites ({gpu}): main() over flat,ivf,ivfpq at {BENCH_ROWS}x{BENCH_DIM}, B="
        f"{BENCH_QUERIES}, in {figs['suites_s']:.1f} s; launches {launches}; K1/K2 by design "
        f"{designs}; strict fallback {figs['fallback']} queries; " + "; ".join(
            f"{r['index']} build {r['build_seconds']} s, optimize {r['optimize_seconds']} s, "
            f"search_avg_ms {r['search_avg_ms']}, qps {r['qps']}, recall_avg {r['recall_avg']}"
            for r in payload))

    # (b) the nprobe sweep over clustered rows
    path = os.path.join(out_dir, "sweep.json")
    t0 = time.perf_counter()
    points, sweep_launches = launches_of(lambda: cli.main(
        [*shape, "--index", "ivf", "--sweep", BENCH_SWEEP, "--out", path]))
    figs["sweep_s"] = time.perf_counter() - t0
    knob, values = BENCH_SWEEP.split("=")
    require([p[knob] for p in points] == [int(v) for v in values.split(",")],
            f"bench sweep: points {points}")
    require(sweep_launches["ivf_probe_scores"] > 0, f"bench sweep: K4 not launched: {sweep_launches}")
    require(all(b["recall_at_k"] >= a["recall_at_k"] for a, b in zip(points, points[1:])),
            f"bench sweep: recall falls as nprobe rises: {points}")
    figs["sweep"], figs["sweep_launches"] = points, sweep_launches
    log(f"bench sweep ({gpu}): {BENCH_SWEEP} over generate_clustered {BENCH_ROWS}x{BENCH_DIM}, "
        f"B={BENCH_QUERIES}, in {figs['sweep_s']:.1f} s: {points}; launches {sweep_launches}")
    torch.cuda.empty_cache()

    # (c) the microbench
    path = os.path.join(out_dir, "microbench.json")
    micro = cli.main(["--microbench", "--n", str(BENCH_ROWS), "--d", str(BENCH_DIM), "--batch",
                      str(BENCH_QUERIES), "--trials", str(BENCH_MICRO_TRIALS), "--device", DEVICE,
                      "--out", path])
    require(micro["ms_per_pass"] > 0 and np.isfinite(micro["corpus_gb_per_s"])
            and micro["bound_ms"] > 0, f"bench microbench: {micro}")
    figs["micro"] = micro
    log(f"bench microbench ({gpu}): l2sqr_block B={micro['batch']} over {micro['n']}x{micro['d']} "
        f"bf16: {micro['ms_per_pass']} ms a pass, {micro['corpus_gb_per_s']} GB/s, "
        f"{micro['row_queries_per_s']} row-queries/s; byte bound {micro['bound_ms']:.4g} ms")
    torch.cuda.empty_cache()

    # (d) the -m entry point, on the card by default
    cmd = [sys.executable, "-m", "vectorindex_tpu_torch.bench", "--index", "flat", "--n",
           str(BENCH_SUB_ROWS), "--d", str(BENCH_DIM), "--queries", str(BENCH_SUB_QUERIES), "--vb"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    figs["subprocess_s"] = time.perf_counter() - t0
    require(proc.returncode == 0, f"bench -m: exit {proc.returncode}: {proc.stderr[-3000:]}")
    run = json.loads(proc.stdout)
    host = run["host"]
    require(host.get("gpu") == gpu and torch.cuda.get_device_name(0) in host["devices"][0],
            f"bench -m: the envelope does not name the card: {host}")
    figs["sub"] = run["results"][0]
    log(f"bench -m ({gpu}): `{' '.join(cmd[1:])}` exit 0 in {figs['subprocess_s']:.1f} s; host "
        f"{host['devices']}, {host.get('gpu')}, torch {host['torch']} CUDA {host['cuda']}; flat qps "
        f"{figs['sub']['qps']}, recall_avg {figs['sub']['recall_avg']}")
    figs["phase_s"] = time.perf_counter() - t_phase
    return figs


def flat_bound(n: int, d: int, b: int, itemsize: int, kernel: str, peak=None):
    """(bound_ms, bound_by) of K1/K2 (K11: K1's) over a flat corpus: rows,
    bias and q read once, the candidates or counts written; the operations
    at `peak` FLOP/s (default: the tensor cores for bf16 rows, the f32 pipe
    for f32; the FMA design on bf16 rows runs on the f32 pipe)."""
    nbytes = n * (d * itemsize + 4) + b * d * 4
    nbytes += b * 3 * 256 * 8 if kernel == "bin_candidates" else b * 12
    if peak is None:
        peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    return bound(nbytes, 2.0 * b * n * d, peak)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    ps = Persist()
    try:
        return run(ps)
    finally:
        ps.close()


def run(ps: Persist) -> int:
    from vectorindex_tpu_torch.kernels import _build, adc as fa, adc_probe as ap, ivf_probe as kp
    from vectorindex_tpu_torch.kernels import scan_fused as sf
    from vectorindex_tpu_torch.ops.topk import topk

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must stay off")
    gpu = gpu_name_and_power()
    log(f"gpu: {gpu}")

    t0 = time.perf_counter()
    _build.load()
    log(f"build: nvcc and load in {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")
    attrs = sf.fma_attributes()
    require(all(local == 0 for _, local in attrs.values()), f"an FMA-design kernel spills: {attrs}")
    log("build: FMA-design kernels' registers (no local memory): " + ", ".join(
        f"{k[0]} {k[1]} {k[2]} {k[3]}x{k[3]} {regs}" for k, (regs, _) in sorted(attrs.items())))
    k8_attrs = fa.k8_ring_attributes()
    require(all(local == 0 for _, local in k8_attrs.values()), f"a K8 kernel spills: {k8_attrs}")
    log("build: K8 kernels' registers (no local memory; (qb, ksp, queries a lane, skew, row "
        "width)): " + ", ".join(f"{k} {regs}" for k, (regs, _) in sorted(k8_attrs.items())))
    wg_attrs = sf.wgmma_attributes()
    require(all(local == 0 for _, local in wg_attrs.values()),
            f"a wgmma-design kernel spills: {wg_attrs}")
    log("build: wgmma-design kernels' registers at entry (no local memory; consumers raise theirs "
        f"to {sf.WG_CONSUMER_REGS} by setmaxnreg): " + ", ".join(
            f"{k[0]} {k[1]} a_regs={k[2]} tiles={k[3]} units={k[4]} {regs}"
            for k, (regs, _) in sorted(wg_attrs.items())))

    errs = phase_compare(sf, topk)
    idx, batches, launches = phase_main(sf)
    times = phase_times(sf, topk, idx, batches, errs)
    launches["bin_candidates_tree"], tree_times = phase_tree(sf, topk, idx, batches, errs)
    range_s = phase_flat_range(idx, batches)
    api = Api()
    with api.timed("api flat"):
        phase_api_flat(sf, topk, idx, batches, api, errs)
    with api.timed("sharded flat"):
        phase_sharded_flat(idx, batches, api)
    phase_persist_flat(sf, idx, batches, ps)
    n_flat, itemsize = idx.capacity, 2
    del idx, batches
    torch.cuda.empty_cache()
    wide_launches, wide_times, wide_errs = phase_flat_wide(sf, topk)
    for name, e in wide_errs.items():
        errs[name] = max(errs[name], e)
    with api.timed("api verified wide"):
        xwide = phase_api_verified_wide(sf, topk, api, errs)
    f32_wide = phase_flat_f32_wide(sf, topk, errs)
    wide_full = phase_flat_wide_full(sf, topk, errs)
    band = phase_flat_band(sf, topk, errs)
    f32_xwide = phase_flat_f32_xwide(sf, topk, errs)

    errs.update(phase_ivf_compare(kp))
    ivf_idx, ivf_batches, bigq, ivf_launches, build_s = phase_ivf_main(kp)
    ivf_times = phase_ivf_times(kp, ivf_idx, ivf_batches, bigq, errs)
    launches.update(ivf_launches)
    with api.timed("api ivf"):
        phase_api_ivf(kp, ivf_idx, ivf_batches, api)
    with api.timed("sharded ivf"):
        phase_sharded_ivf(ivf_idx, ivf_batches, bigq, api)
    phase_persist_ivf(kp, ivf_idx, ivf_batches, bigq, ps)
    del ivf_idx, ivf_batches, bigq
    torch.cuda.empty_cache()

    pq_errs, pq_launches, tier_launches, pq_times, pq_builds = phase_pq(ap, ps, api)
    errs.update(pq_errs)
    launches.update(pq_launches)
    torch.cuda.empty_cache()

    adc_errs, adc_launches, adc_times, adc_figs = phase_adc(fa)
    errs.update(adc_errs)
    launches.update(adc_launches)
    torch.cuda.empty_cache()

    host_launches, host_errs, hostpq = phase_hostpq(ap, gpu)
    for name, e in host_errs.items():
        errs[name] = max(errs[name], e)

    hnsw = phase_hnsw(gpu, ps, api)
    replay = phase_kmeans_replay()
    bench = phase_bench(sf, kp, ap, topk, gpu, errs)
    log(persist_summary(ps, gpu))
    log(api_summary(api, gpu))
    log(f"hnsw: gpu {gpu}; build {hnsw['build_s']:.2f} s (100k x 128, defaults), recall@{MAIN_K} "
        f"{hnsw['recall']}, B={HNSW_BATCH} wall {hnsw['b256_ms']:.4g} ms ({hnsw['qps']:.1f} QPS), "
        f"B={SMALL_BATCH} wall {hnsw['b8_ms']:.4g} ms, stream {hnsw['stream_qps']:.1f} QPS, "
        f"device_search {hnsw['launches']} launches, device busy {hnsw['busy_ms']:.4g} ms of "
        f"{hnsw['device_search_ms']:.4g} ms; k-means replay {replay['kmeans_s']} s, pq_train "
        f"{replay['pq_train_s']} s")
    micro = bench["micro"]
    log(f"bench: gpu {gpu}; python -m vectorindex_tpu_torch.bench at {BENCH_ROWS}x{BENCH_DIM}, B="
        f"{BENCH_QUERIES}: " + "; ".join(
            f"{r['index']} build {r['build_seconds']} s, optimize {r['optimize_seconds']} s, "
            f"search_avg_ms {r['search_avg_ms']}, qps {r['qps']}, recall_avg {r['recall_avg']}"
            for r in bench["suites"])
        + f"; flat recall {bench['flat']['recall_tie']} under the tie rule; sweep " + ", ".join(
            f"nprobe {p['nprobe']} recall {p['recall_at_k']} qps {p['qps']}" for p in bench["sweep"])
        + f"; microbench {micro['ms_per_pass']} ms a pass ({micro['corpus_gb_per_s']} GB/s, byte "
        f"bound {micro['bound_ms']:.4g} ms); -m subprocess {bench['subprocess_s']:.1f} s; phase "
        f"{bench['phase_s']:.1f} s")

    big = times[MAIN_BATCH]
    kernels = []
    for name in ("bin_candidates", "count_below"):
        # the wgmma design at B=256 (and B=8 below), each timed in turns with
        # the first tensor-core design
        bms, by = flat_bound(n_flat, MAIN_DIM, MAIN_BATCH, itemsize, name)
        kernels.append({"name": name, "ms": big[name], "plain_ms": big[name + "_plain"],
                        "bound_ms": bms, "bound_by": by, "device_ms": big[name + "_dev"],
                        "first_design_ms": big[name + "_v1"],
                        "first_design_device_ms": big[name + "_v1_dev"],
                        "plan": big[name + "_plan"], **narrow_fields(big["narrow"], name)})
        small = times[SMALL_BATCH]
        kernels[-1][f"B={SMALL_BATCH}"] = design_shape(
            small, name, flat_bound(n_flat, MAIN_DIM, SMALL_BATCH, itemsize, name))
    m = api.figs["mips"]
    bf = bench["flat"]
    for k in kernels:  # K1/K2 also at d = 256 on phase_api's MIPS index, B=256
        name = k["name"]
        k["mips"] = {"ms": m[name + "_ms"], "device_ms": m[name + "_device_ms"],
                     "first_design_ms": m[name + "_first_design_ms"],
                     "first_design_device_ms": m[name + "_first_design_device_ms"],
                     "bound_ms": m[name + "_bound"][0], "bound_by": m[name + "_bound"][1],
                     "cublas_product_ms": m["cublas_product_ms"],
                     **narrow_fields(m["narrow"], name)}
        # wide bf16 rows on the wgmma design, each timed in turns with the
        # FMA design (their earlier route), beside cuBLAS's bf16 q x^T alone
        def wide_shape(t, launches=None):
            fig = design_shape(t, name, t[name + "_bound"], launches)
            fig.update(f32_pipe_ms=t[name + "_f32_pipe"], cublas_product_ms=t["cublas_product_ms"])
            return fig

        k["wgmma_wide"] = {
            f"bf16 {FLAT_WIDE_CAPACITY}x{FLAT_WIDE_DIM} B={FLAT_WIDE_BATCHES[-1]} (wide)": wide_shape(
                wide_times, wide_launches[name]),
            **{f"bf16 {VERIFIED_ROWS}x{VERIFIED_DIM} B={b} (api verified wide)": wide_shape(
                xwide[b], xwide[b]["launches"][name]) for b in VERIFIED_BATCHES},
            **{f"bf16 {FLAT_4K_ROWS}x{FLAT_4K_DIM} B={b} (4k wide)": wide_shape(
                wide_full[b], wide_full[b]["launches"][name]) for b in FLAT_4K_BATCHES},
            **{f"bf16 {FLAT_BAND_ROWS}x{FLAT_BAND_DIM} B={b} (band)": wide_shape(
                band[b], band[b]["launches"][name]) for b in FLAT_BAND_BATCHES},
        }
        # and on the FMA design: the bench CLI's f32 flat index (B=256, its
        # launches; B=8), the f32 rows at d = 768 and at d = 8,192 (past the
        # first FMA design: no earlier design in turns)
        xw = f32_xwide
        k["fma"] = {
            f"f32 {BENCH_ROWS}x{BENCH_DIM} B={BENCH_QUERIES} (bench flat)": design_shape(
                bf[BENCH_QUERIES], name, bf[BENCH_QUERIES][name + "_bound"],
                bench["launches"][name]),
            f"f32 {BENCH_ROWS}x{BENCH_DIM} B={SMALL_BATCH}": design_shape(
                bf[SMALL_BATCH], name, bf[SMALL_BATCH][name + "_bound"]),
            **{f"f32 {FLAT_F32_WIDE_ROWS}x{FLAT_F32_WIDE_DIM} B={b}": design_shape(
                f32_wide[b], name, f32_wide[b][name + "_bound"], f32_wide[b]["launches"][name])
               for b in FLAT_F32_WIDE_BATCHES},
            f"f32 {FLAT_F32_XWIDE_ROWS}x{FLAT_F32_XWIDE_DIM} B={FLAT_F32_XWIDE_BATCH}": {
                "ms": xw[name], "device_ms": xw[name + "_dev"], "plain_ms": xw[name + "_plain"],
                "bound_ms": xw[name + "_bound"][0], "bound_by": xw[name + "_bound"][1],
                "plan": xw[name + "_plan"], "launches": xw["launches"][name]},
        }
    bms, by = flat_bound(n_flat, MAIN_DIM, MAIN_BATCH, itemsize, "bin_candidates")
    tree = tree_times[TREE_TILES[0]]
    kernels.append({"name": "bin_candidates_tree", "ms": tree["ms"],
                    "plain_ms": tree["plain_ms"], "bound_ms": bms, "bound_by": by,
                    "device_ms": tree["device_ms"], "first_design_ms": tree["first_design_ms"],
                    "first_design_device_ms": tree["first_design_device_ms"],
                    f"tile={TREE_TILES[1]}": {k: v for k, v in tree_times[TREE_TILES[1]].items()
                                              if k != "flagged"}})
    # cuBLAS's bf16 q x^T at the main shape: the product alone (not K1's
    # function, so not a library call of it), a yardstick for K1, K2 and K11
    for k in kernels:
        k["cublas_product_ms"] = tree_times["matmul_ms"]
        k["cublas_product_device_ms"] = tree_times["matmul_device_ms"]
    for name in ("ivf_probe_topc", "ivf_probe_scores", "ivf_probe_scores_rankmajor"):
        bms, by = ivf_times[name + "_bound"]
        kernels.append({"name": name, "ms": ivf_times[name], "plain_ms": ivf_times[name + "_plain"],
                        "bound_ms": bms, "bound_by": by,
                        "first_design_ms": ivf_times[name + "_v1"]})  # timed in turns
    clock = adc_times["sm_clock_mhz"]
    for name in PQ_KERNELS:  # pq16's: K10 at B=8, K9 at B=256; each timed in turns with its first design
        pt = pq_times["pq16"]
        bms, by = pt[name + "_bound"]
        kernels.append({"name": name, "ms": pt[name], "plain_ms": pt[name + "_plain"],
                        "bound_ms": bms, "bound_by": by,
                        "lookup_floor_ms": lookup_floor_ms(pt[name + "_lookups"], clock),
                        "first_design_ms": pt[name + "_v1"], "device_ms": pt[name + "_dev"],
                        "first_design_device_ms": pt[name + "_v1_dev"]})
        if name == "adc_probe_scores":  # K9 also at the hostpq shape (B=64, nprobe=8, 10M rows)
            k9 = hostpq["k9"]
            kernels[-1]["hostpq"] = {"ms": k9["ms"], "device_ms": k9["device_ms"],
                                     "plain_ms": k9["plain_ms"], "bound_ms": k9["bound"][0],
                                     "bound_by": k9["bound"][1]}
    # K6/K7 at B=64 (timed in turns with their first designs), K8 at B=256
    # (with its second)
    for name in ADC_KERNELS:
        bms, by = adc_times[name + "_bound"]
        kernels.append({"name": name, "ms": adc_times[name], "plain_ms": adc_times[name + "_plain"],
                        "bound_ms": bms, "bound_by": by,
                        "lookup_floor_ms": lookup_floor_ms(adc_times[name + "_lookups"], clock),
                        "device_ms": adc_times[name + "_dev"]})
        which = "second" if name == "adc_topk_fused" else "first"
        kernels[-1][which + "_design_ms"] = adc_times[name + "_old"]
        kernels[-1][which + "_design_device_ms"] = adc_times[name + "_old_dev"]
        kernels[-1]["rounds"] = adc_times[name + "_rounds"]
        if name != "adc_topk_fused":
            kernels[-1]["write_floor_ms"] = adc_times["write_floor"]
        else:
            kernels[-1]["plan"] = adc_times[name + "_plan"]
    # embedding_bag computes K6's function in one call; no single PyTorch
    # call computes a per-class top-3, a count below tau, distances (or
    # LUT-gather sums) over per-query probed row lists, or reads packed u4
    library = {"adc_scan_u8": adc_times["adc_scan_u8_library"]}
    # `launches` is the kernel's main path's own count; the other paths'
    # runs, each counted from 0 just before it, stand under "paths"
    other = {"pq_host_tier": tier_launches, "hostpq": host_launches, "persist": ps.launches,
             **api.launches, "bench": bench["launches"], "bench_sweep": bench["sweep_launches"],
             "flat_wide (wgmma)": wide_launches, "api_verified_wide (wgmma)": xwide["launches"],
             "flat_wide_4k (wgmma)": wide_full["launches"], "flat_band (wgmma)": band["launches"],
             "flat_f32_wide (fma)": {n: sum(f32_wide[b]["launches"][n] for b in FLAT_F32_WIDE_BATCHES)
                                     for n in ("bin_candidates", "count_below")},
             "flat_f32_xwide (fma)": f32_xwide["launches"]}
    for k in kernels:
        k.update(route="cuda", source=SOURCES[k["name"]], replaces=REPLACES[k["name"]],
                 launches=launches[k["name"]], max_abs_err=errs[k["name"]],
                 library_ms=library.get(k["name"]),
                 paths={p: c[k["name"]] for p, c in other.items() if c.get(k["name"])})
        k.setdefault("lookup_floor_ms", None)
    require(all(k["launches"] > 0 for k in kernels),
            f"a kernel did not run on its main path: {launches}")
    log(f"gpu: {gpu}; flat batch_search B={MAIN_BATCH}: {big['qps']:.1f} QPS; wide bf16 d="
        f"{FLAT_WIDE_DIM} K1/K2 on the wgmma design (launches {wide_launches}) "
        f"{wide_times['bin_candidates']:.4g} / {wide_times['count_below']:.4g} ms at B="
        f"{FLAT_WIDE_BATCHES[-1]} (FMA design {wide_times['bin_candidates_v1']:.4g} / "
        f"{wide_times['count_below_v1']:.4g}); d={VERIFIED_DIM} "
        + ", ".join(f"B={b} {xwide[b]['bin_candidates']:.4g} / {xwide[b]['count_below']:.4g} ms"
                    for b in VERIFIED_BATCHES)
        + f"; {FLAT_4K_ROWS}x{FLAT_4K_DIM} "
        + ", ".join(f"B={b} {wide_full[b]['bin_candidates']:.4g} / "
                    f"{wide_full[b]['count_below']:.4g} ms (FMA design "
                    f"{wide_full[b]['bin_candidates_v1']:.4g} / {wide_full[b]['count_below_v1']:.4g})"
                    for b in FLAT_4K_BATCHES)
        + f"; band {FLAT_BAND_ROWS}x{FLAT_BAND_DIM} "
        + ", ".join(f"B={b} {band[b]['bin_candidates']:.4g} / {band[b]['count_below']:.4g} ms "
                    f"(narrow tile {band[b]['narrow']['bin_candidates_narrow']:.4g} / "
                    f"{band[b]['narrow']['count_below_narrow']:.4g})" for b in FLAT_BAND_BATCHES)
        + f"; f32 d={FLAT_F32_XWIDE_DIM} B={FLAT_F32_XWIDE_BATCH} {f32_xwide['bin_candidates']:.4g} / "
        f"{f32_xwide['count_below']:.4g} ms; f32 FMA {BENCH_ROWS}x{BENCH_DIM} B={BENCH_QUERIES} "
        f"{bf[BENCH_QUERIES]['bin_candidates']:.4g} / {bf[BENCH_QUERIES]['count_below']:.4g} ms (first "
        f"design {bf[BENCH_QUERIES]['bin_candidates_v1']:.4g} / "
        f"{bf[BENCH_QUERIES]['count_below_v1']:.4g}), "
        + ", ".join(f"{FLAT_F32_WIDE_ROWS}x{FLAT_F32_WIDE_DIM} B={b} "
                    f"{f32_wide[b]['bin_candidates']:.4g} / {f32_wide[b]['count_below']:.4g} ms"
                    for b in FLAT_F32_WIDE_BATCHES)
        + f"; K6 device {adc_times['adc_scan_u8_dev']:.4g} ms (first design "
        f"{adc_times['adc_scan_u8_old_dev']:.4g} ms), K7 {adc_times['adc_scan_u4_dev']:.4g} ms ("
        f"{adc_times['adc_scan_u4_old_dev']:.4g} ms), write floor {adc_times['write_floor']:.4g} ms; "
        f"adc range B={ADC_RANGE_BATCH} wall {adc_times['range_wall']:.4g} ms (K6 "
        f"{adc_times['range_k6_wall']:.4g}, mask and sort {adc_times['range_compact_wall']:.4g}); "
        f"K8 {adc_times['adc_topk_fused']:.4g} ms, device {adc_times['adc_topk_fused_dev']:.4g} ms "
        f"(second design {adc_times['adc_topk_fused_old']:.4g} ms, device "
        f"{adc_times['adc_topk_fused_old_dev']:.4g} ms); ivf K4 B={IVF_BIG_BATCH} "
        f"{ivf_times['ivf_probe_scores']:.4g} ms (first design "
        f"{ivf_times['ivf_probe_scores_v1']:.4g} ms), K3 B={SMALL_BATCH} "
        f"{ivf_times['ivf_probe_topc']:.4g} ms (first design {ivf_times['ivf_probe_topc_v1']:.4g} "
        f"ms); adc B={ADC_BATCH} walls "
        + ", ".join(f"{c} {adc_times[f'search {c}'][0]:.4g} ms" for c in
                    ("adc_only", *(f"rerank{r}" for r in ADC_RERANK)))
        + "; ivf insert_batch "
        f"{build_s['insert_s']:.2f} s, optimize {build_s['optimize_s']:.2f} s; ivfpq "
        + "; ".join(f"{name} recall@{MAIN_K} {b['recall']}, insert {b['insert_s']:.2f} s, optimize "
                    f"{b['optimize_s']:.2f} s" for name, b in pq_builds.items())
        + f"; pq16 host tier walls {pq_builds['pq16']['host_tier_ms']}; hostpq 10M recall@{MAIN_K} "
        f"{hostpq['recall']}, {hostpq['device_bytes_per_row']:.3f} device B a row, per call "
        f"{hostpq['per_call_ms']:.4g} ms, stream {hostpq['pipelined_qps']:.1f} QPS, candidates "
        f"{hostpq['candidates_ms']:.4g} ms, ids D2H {hostpq['d2h_ms']:.4g} ms, native rerank "
        f"{hostpq['rerank_ms']:.4g} ms ({hostpq['rerank_threads']} threads), phase "
        f"{hostpq['phase_s']:.1f} s"
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
