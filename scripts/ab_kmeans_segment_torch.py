#!/usr/bin/env python3
"""A/B of k-means' per-cluster sum on one GPU: two designs with no float atomics against index_add_.

    python3 scripts/ab_kmeans_segment_torch.py [--iters 10]

ops/kmeans._segment_mean sums each cluster's rows once per Lloyd iteration.
`index_add_` adds floats by atomics on CUDA, in no fixed order, so k-means
could not be replayed from its seed. This script times, at two shapes of the
IVF-PQ path (1,000,000 x 96 rows into nlist = 4,096 clusters: the coarse
quantizer; 131,072 x 6 rows into ks = 256: one pq16 subspace of pq_train),
by CUDA events in two rounds (forward, then reversed):

  - sorted: a stable sort of the rows by assignment, then torch.segment_reduce
    over the sorted rows (each cluster's rows in ascending row order);
  - onehot: the JAX package's one-hot product in row chunks of 8,192,
    [k, chunk] one-hot @ [chunk, d] rows accumulated in f32 (TF32 off);
  - index_add: the former code, for reference.

Before timing, each design is run twice and must give the same bits, and the
sorted design's sums must equal index_add_'s on the CPU bit for bit (both add
each cluster's rows in row order).

Then the replay check: each of these runs twice from one seed on the card,
and the script prints whether the two give the same bits: torch.multinomial
with 2,048 draws and with 1 (k-means‖'s oversampling and k-means++'s pick),
ops/rng.inverse_cdf_pick with 2,048, and k-means as IVFIndex.optimize runs
it at nlist=1,024 (k-means‖ seeding) over 262,144 x 128 lowdim rows.

Prints the card's name and power limit and one JSON line of times and
replays. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import KM_DIM, KM_NLIST, KM_ROWS, SEED, gpu_name_and_power, time_ms  # noqa: E402
from vectorindex_tpu_torch.bench.synth import lowdim_corpus  # noqa: E402
from vectorindex_tpu_torch.models.ivf import IVFConfig  # noqa: E402
from vectorindex_tpu_torch.ops import kmeans as km  # noqa: E402
from vectorindex_tpu_torch.ops import rng as vrng  # noqa: E402

SHAPES = {"ivf_nlist4096": (1_000_000, 96, 4096), "pq_train_ks256": (131_072, 6, 256)}
ONEHOT_CHUNK = 8192


def segment_sorted(x, assign, k):
    return km._segment_mean(x, assign, k)[0]


def segment_onehot(x, assign, k, chunk=ONEHOT_CHUNK):
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    ks = torch.arange(k, device=x.device)[:, None]
    for s in range(0, x.shape[0], chunk):
        onehot = (assign[None, s : s + chunk] == ks).float()
        sums.addmm_(onehot, x[s : s + chunk])
    return sums


def segment_index_add(x, assign, k):
    return torch.zeros((k, x.shape[1]), device=x.device).index_add_(0, assign.long(), x)


DESIGNS = {"sorted": segment_sorted, "onehot": segment_onehot, "index_add": segment_index_add}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"gpu: {gpu_name_and_power()}", flush=True)
    out = {}
    for shape, (n, d, k) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(n + k)
        x = torch.randn(n, d, generator=gen, device="cuda")
        centroids = x[torch.randperm(n, generator=gen, device="cuda")[:k]]
        assign, _ = km.assign_clusters_chunked(x, centroids)
        for name, fn in DESIGNS.items():
            if name != "index_add":
                a, b = fn(x, assign, k), fn(x, assign, k)
                assert torch.equal(a, b), f"{shape}: {name} differs between two runs"
        cpu = segment_index_add(x.cpu(), assign.cpu(), k)
        assert torch.equal(segment_sorted(x, assign, k).cpu(), cpu), f"{shape}: sorted != CPU"
        onehot_err = float((segment_onehot(x, assign, k).cpu() - cpu).abs().max())
        times = {name: [] for name in DESIGNS}
        for order in (list(DESIGNS), list(reversed(DESIGNS))):
            for name in order:
                times[name].append(time_ms(lambda: DESIGNS[name](x, assign, k), args.iters))
        out[shape] = {"n": n, "d": d, "k": k, "ms": times,
                      "onehot_max_abs_diff_from_row_order": onehot_err}
        print(f"{shape}: " + ", ".join(f"{n_} {t}" for n_, t in times.items()), flush=True)
    out["replays"] = replays()
    print(json.dumps(out), flush=True)
    return 0


def replays() -> dict:
    """{name: whether two runs from one seed give the same bits}."""
    x, _ = lowdim_corpus(KM_ROWS, KM_DIM, seed=SEED)
    xd = torch.from_numpy(x).cuda()
    w = (xd * xd).sum(dim=1) + 0.1  # D²-like weights over the rows

    def gen():
        return torch.Generator(device="cuda").manual_seed(3)

    cfg = km.KMeansConfig(k=KM_NLIST, iters=IVFConfig().train_iters, algo="lloyd",
                          seed=IVFConfig().seed)
    cases = {
        "multinomial_2048": lambda: torch.multinomial(w, 2048, replacement=True, generator=gen()),
        "multinomial_1": lambda: torch.multinomial(w, 1, replacement=True, generator=gen()),
        "inverse_cdf_pick_2048": lambda: vrng.inverse_cdf_pick(gen(), w, 2048),
        f"kmeans_nlist{KM_NLIST}": lambda: km.kmeans(xd, cfg).centroids,
    }
    out = {name: bool(torch.equal(fn(), fn())) for name, fn in cases.items()}
    print("replays: " + ", ".join(f"{n} {'same bits' if v else 'DIFFERS'}" for n, v in out.items()),
          flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
