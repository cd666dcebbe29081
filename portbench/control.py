"""The comparison's control: the reference in the program's place, in the
nearest precision below the one the configuration states.

    python3 -m portbench.control --config <name> --seeds 1,2,3 [--answers N]

For each seed it draws the configuration's rows and queries as a run does,
takes `--answers` queries from the pool (a run checks that many), answers
them with the reference computed in the control precision (the
configuration's `reference.control`: float8_e4m3 below bfloat16 storage,
tf32 below float32), and prints the comparison's numbers beside the
configuration's limits, one JSON line a seed. A control that passes every
limit shows a comparison too loose to see that step. Benchmark runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import compare, data, reference
from portbench.run import HERE, index_module, load_config


def control_numbers(cfg: dict, seed: int, answers: int, device: torch.device) -> dict:
    """The comparison's numbers for the control's answers on `seed`."""
    rows, queries = data.make(cfg, seed, device)
    rng = np.random.default_rng([seed % (1 << 63), 13])
    qidx = np.sort(rng.integers(0, queries.shape[0], answers))
    uniq, inv = np.unique(qidx, return_inverse=True)
    ref_ids, ref_dist = compare.reference_topk(rows, queries[uniq], cfg, device)
    ctl_ids, ctl_dist = compare.reference_topk(rows, queries[uniq], cfg, device, control=True)
    scores = reference.public_scores(ctl_dist, cfg["metric"])
    return compare.numbers(
        rows, queries, cfg, qidx, ctl_ids[inv], scores[inv], (ref_ids[inv], ref_dist[inv]), device,
        index_module(cfg).ANSWER,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control", description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--answers", type=int, default=2048)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cfg = load_config(args.config, HERE)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        found = control_numbers(cfg, seed, args.answers, device)
        ok, checks = compare.judge(found, cfg["limits"])
        print(json.dumps({"config": args.config, "seed": seed, "control": cfg["reference"]["control"],
                          "answers": args.answers, "passes_limits": ok, "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
