"""The benchmark finds configurations, mixes and metric readers by name, and
takes up new ones added as files and BENCHMARK.json entries alone."""

import hashlib
import json
import re

import pytest

from conftest import ROOT, run_toy

from portbench.run import HERE, cell_metrics, load_benchmark, load_config, load_mix, metric_reader

BENCH = load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg = load_config(w["config"], HERE)
    assert cfg["name"] == w["config"]
    assert load_mix(w["traffic"], HERE)["name"] == w["traffic"]
    assert w["chips"] == 1
    e2e = cell_metrics(BENCH, cell, False)
    layers = cell_metrics(BENCH, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layers
    for m in e2e + layers:
        assert callable(metric_reader(m["name"], HERE))
    # every per-layer metric moves an end-to-end metric this cell reports
    assert {m["moves"] for m in layers} <= {m["name"] for m in e2e}


def test_benchmark_file_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()}


def test_new_config_mix_and_metric_are_taken_up_as_files(toy_bench):
    """A configuration, a mix and a per-layer metric added as files and
    entries are run, with no file that was there edited."""
    root, bench = toy_bench
    before = _digest(root)
    (root / "portbench" / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    bench["per_layer"].append({"name": "calls_seen.batch", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "index API", "moves": "qps",
                               "workloads": ["toy-f32-cos.toy4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    out = run_toy(root, bench, "toy-f32-cos.toy4", traced=True)
    assert out["correct"] is True
    assert out["metrics"]["calls_seen.batch"]["value"] >= 1
    assert out["metrics"]["calls_seen.batch"]["unit"] == "calls"


BRUTE = '''"""brute: a plain exhaustive L2 search in numpy, answered in the recall
form. With SKIP set, each answer leaves out its nearest row and takes the
(k+1)-th: approximate, as an ANN index is."""

import numpy as np

ANSWER = "recall"
SKIP = {skip}


def build(cfg, rows, device):
    return rows.astype(np.float64)


def search(index, queries, k, allow=None):
    d = ((queries.astype(np.float64)[:, None, :] - index[None]) ** 2).sum(-1)
    if allow is not None:
        shut = np.full(index.shape[0], np.inf)
        shut[allow] = 0.0
        d = d + shut
    top = np.argsort(d, 1, kind="stable")[:, SKIP : SKIP + k]
    return [[(int(i), float(np.sqrt(d[b, i]))) for i in row] for b, row in enumerate(top)]


def pairs(result):
    return result
'''


def _add_cell(root, bench, cfg, mix, cell_kind="batch256", name=None):
    """Add a configuration (or, with cfg None, take the one named) and a mix
    as files, and their cell as entries."""
    here = root / "portbench"
    if cfg is not None:
        (here / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": "toy",
                                 "file": f"portbench/configs/{cfg['name']}.json", "reduced": [], "why": "tests"})
        name = cfg["name"]
    (here / "traffic" / f"{mix['name']}.json").write_text(json.dumps(mix))
    cell = f"{name}.{mix['name']}"
    bench["workloads"].append({"name": cell, "config": name, "traffic": mix["name"], "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and any(w.endswith("." + cell_kind) for w in m["workloads"]):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.mark.parametrize("skip,correct", [(0, True), (1, True), (5, False)])
def test_new_index_type_is_taken_up_as_files(toy_bench, skip, correct):
    """A second index type, added as indexes/<type>.py with a configuration
    that names it, runs with no file that was there edited; its answers are
    held in the recall form: leaving out the nearest row is within the
    configuration's recall limit, leaving out five is not."""
    from conftest import TOY_CONFIGS, TOY_MIXES

    root, bench = toy_bench
    before = _digest(root)
    (root / "portbench" / "indexes" / "brute.py").write_text(BRUTE.replace("{skip}", str(skip)))
    cfg = dict(TOY_CONFIGS["toy-int-l2-bf16"], name="toy-brute", rows=500,
               index={"type": "brute", "storage_dtype": "float32"},
               limits={"missing": 0, "recall_loss": 0.15, "score_err": 1e-4})
    cell = _add_cell(root, bench, cfg, dict(TOY_MIXES["toy4"], name="toy4b"))
    assert {k: v for k, v in _digest(root).items() if k in before} == before
    out = run_toy(root, bench, cell)
    assert set(out["checks"]) == {"missing", "recall_loss", "score_err"}
    assert out["correct"] is correct, out["checks"]
    assert out["checks"]["recall_loss"]["value"] == pytest.approx(skip / 10)
    traced = run_toy(root, bench, cell, traced=True)
    assert "scan_roofline.batch" not in traced["metrics"]


@pytest.mark.parametrize("mix", [
    {"name": "toyf", "loop": "closed", "clients": 1, "batch": 4, "k": None, "order": "shuffle",
     "filter": {"allow_share": 0.1}, "check_share": 1.0, "users": "tests"},
    {"name": "toyo", "loop": "open", "clients": 1, "batch": 8, "rate": 400.0, "arrivals": "poisson",
     "k": 5, "order": "cycle", "filter": None, "check_share": 1.0, "users": "tests"},
], ids=["filtered_shuffled", "open_loop"])
def test_new_mixes_are_taken_up_as_files(toy_bench, mix):
    """A filtered, shuffled mix and an open loop at a fixed rate, added as
    data files alone, run and are held to the reference: the filter's ids
    and the mix's own k included."""
    root, bench = toy_bench
    before = _digest(root)
    cell = _add_cell(root, bench, None, mix, "serial" if mix["loop"] == "open" else "batch256",
                     name="toy-int-l2-bf16")
    assert {k: v for k, v in _digest(root).items() if k in before} == before
    out = run_toy(root, bench, cell, seconds=0.5)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    if mix["loop"] == "open":
        # about rate x seconds arrivals, each a request of its own
        assert 100 <= out["attempted"] <= 400
        assert out["metrics"]["latency_p95_ms"]["value"] > 0
    else:
        assert out["metrics"]["qps"]["value"] > 0
