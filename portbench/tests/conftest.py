"""Toy cells for the benchmark's CPU tests.

`toy_bench` copies the benchmark (BENCHMARK.json and portbench/) into a
temporary directory and adds two small configurations, two mixes and their
cells as files and entries, the way a later change adds a cell. Runs there
take the kernels' plain versions on the CPU; no test looks for a card
before a fixture runs.
"""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

TOY_CONFIGS = {
    "toy-int-l2-bf16": {
        "name": "toy-int-l2-bf16", "source": "toy", "rows": 3000, "dimension": 16,
        "metric": "l2", "k": 10, "queries": 64,
        "index": {"type": "flat", "capacity": 3000, "storage_dtype": "bfloat16"},
        "data": {"generator": "clustered", "clusters": 8, "center_std": 30.0, "noise_std": 18.0,
                 "offset": 40.0, "integer": True, "clip": [0.0, 255.0], "normalize": False},
        "reference": {"control": "float8_e4m3"},
        "limits": {"missing": 0, "id_diff": 0, "rank_gap": 0, "score_err": 0},
        "reduced": [], "assumed": {},
    },
    "toy-f32-cos": {
        "name": "toy-f32-cos", "source": "toy", "rows": 3000, "dimension": 64,
        "metric": "cosine", "k": 10, "queries": 50,
        "index": {"type": "flat", "capacity": 3000, "storage_dtype": "float32"},
        "data": {"generator": "clustered", "clusters": 8, "center_std": 1.0, "noise_std": 0.75,
                 "offset": 0.0, "integer": False, "clip": None, "normalize": True},
        "reference": {"control": "tf32"},
        "limits": {"missing": 0, "rank_gap": 1e-6, "score_err": 1e-6},
        "reduced": [], "assumed": {},
    },
}
TOY_MIXES = {
    "toy4": {"name": "toy4", "loop": "closed", "clients": 1, "batch": 4, "k": None,
             "order": "cycle", "filter": None, "check_share": 1.0, "users": "tests"},
    "toy1": {"name": "toy1", "loop": "closed", "clients": 1, "batch": 1, "k": None,
             "order": "cycle", "filter": None, "check_share": 1.0, "users": "tests"},
    "toy4f": {"name": "toy4f", "loop": "closed", "clients": 1, "batch": 4, "k": None,
              "order": "cycle", "filter": {"allow_share": 0.2}, "check_share": 1.0, "users": "tests"},
}
TOY_CELLS = [
    ("toy-int-l2-bf16.toy4", "toy-int-l2-bf16", "toy4"),
    ("toy-int-l2-bf16.toy1", "toy-int-l2-bf16", "toy1"),
    ("toy-f32-cos.toy4", "toy-f32-cos", "toy4"),
    ("toy-f32-cos.toy4f", "toy-f32-cos", "toy4f"),
]


def add_toys(root: Path) -> dict:
    """Add the toy configurations, mixes and cells under root; returns the
    extended benchmark."""
    here = root / "portbench"
    for name, cfg in TOY_CONFIGS.items():
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, mix in TOY_MIXES.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in TOY_CONFIGS:
        bench["configs"].append({"name": name, "source": "toy", "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "tests"})
    for cell, cfg, mix in TOY_CELLS:
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": 1, "why": "tests"})
        kind = "serial" if mix == "toy1" else "batch256"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith("." + kind) for w in m["workloads"]):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return bench


def copy_benchmark(dest: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def toy_bench(tmp_path):
    """(root of a copy with the toy cells, its benchmark)."""
    root = copy_benchmark(tmp_path)
    return root, add_toys(root)


def run_toy(root: Path, bench: dict, cell: str, seed: int = 5, traced: bool = False,
            seconds: float = 0.3) -> dict:
    from portbench.run import run_cell

    return run_cell(bench, cell, seed, seconds, traced, torch.device("cpu"),
                    time.perf_counter(), here=root / "portbench")
