"""Run one benchmark cell once: build, warm, measure, check, report.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name. `BENCHMARK.json` at the
repository root names the cell's configuration and traffic mix;
`configs/<config>.json` holds the configuration (sizes, data, index,
limits), `traffic/<mix>.json` the mix (load.py reads it),
`indexes/<index.type>.py` builds and searches the index and names the form
its answers are compared in, and each metric is read by
`metrics/<name>.py`, or, where that file is absent, by
`metrics/<name up to its first dot>.py` (one reader for a quantity split by
the end-to-end metric it moves). A reader's `read(run)` returns the
number, a (number, note) pair, or None where it finds nothing to read; the
metric is then left out of the line.

The program is driven through its public API alone, from the index
module, with `TELEM`'s spans, flags and counters and the flat scan's launch
counter (`scan_fused.LAUNCHES`) beside it. Set-up draws the rows and
queries on the device from the seed, copies them to the host once, lets
the index module build the kernels on a small index, builds the timed
index, and searches at each call size the window will use (the first
search uploads the index). Where the index module names a rare path's
counter, set-up searches on in the pool's order until a query takes that
path, for at most WARM_RARE_CALLS calls and one pass over the pool, so that
the window loads no kernel. The window runs the mix for `--seconds`; the
last call that starts in it is waited for and counted. With `--trace 1`
the program's telemetry runs over the window and torch.profiler over its
first TRACE_SECONDS, and the line carries the per-layer metrics instead of
the end-to-end ones. Once the window has closed and the device's peak
memory is read, the index is freed and the answers of a sample of calls
drawn from the seed are held against the plain reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

import numpy as np
import torch

from portbench import compare, data, load, trace as tracing

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "vectorindex_tpu")
#: searches at each call size before the window (the first uploads the
#: index)
WARM_CALLS = 3
#: calls set-up makes at most in search of a query that takes the index's
#: rare path (and never more than one pass over the pool): a share of 0.25%
#: of queries, as BIGANN's ties send to the strict fallback, is met within
#: 2,048 one-query calls in all but 0.6% of runs
WARM_RARE_CALLS = 2048
#: seconds past the window's close that an open loop serves the queries
#: that arrived in it; those still waiting then count as failed
DRAIN_SECONDS = 60.0
#: seconds at the start of a traced window that torch.profiler records (its
#: events take tens of seconds a traced second to read back)
TRACE_SECONDS = 5.0


@dataclass
class Run:
    """What one run measured, as the metric readers see it."""

    cfg: dict
    kind: str
    batch: int
    k: int
    setup_s: float = 0.0
    insert_s: float = 0.0
    calls: int = 0
    #: queries that arrived in the window (a closed loop: that were sent)
    attempted: int = 0
    #: queries answered
    queries: int = 0
    failed: int = 0
    wall_s: float = 0.0
    #: a call's wall and its number of queries, for every call
    call_s: list = field(default_factory=list)
    sizes: list = field(default_factory=list)
    #: a request's latency: a call's wall in a closed loop, a query's time
    #: from arrival to answer in an open one
    latency_s: list = field(default_factory=list)
    #: a call's TELEM spans ({stage: ms}) and flags; traced runs only
    stage_ms: list = field(default_factory=list)
    flags: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    #: seconds of the window the profiler recorded; traced runs only
    trace_s: float = 0.0
    trace_launches: int = 0
    #: busy_s and window_s of the profiled seconds; traced runs only
    trace: Optional[dict] = None


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r}")


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise SystemExit(f"portbench: {path} not found")
    with open(path) as f:
        return json.load(f)


def load_config(name: str, here: Path = HERE) -> dict:
    return _load_json(here / "configs" / f"{name}.json")


def load_mix(name: str, here: Path = HERE) -> dict:
    return _load_json(here / "traffic" / f"{name}.json")


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def index_module(cfg: dict, here: Path = HERE) -> ModuleType:
    """indexes/<the configuration's index.type>.py."""
    kind = cfg["index"]["type"]
    path = here / "indexes" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no index module for type {kind!r} ({path})")
    module = _module(path, f"portbench_index_{kind}")
    if module.ANSWER not in compare.FORMS:
        raise SystemExit(f"portbench: index type {kind!r} answers in unknown form {module.ANSWER!r}")
    return module


def metric_reader(name: str, here: Path = HERE) -> Callable:
    """`read` of metrics/<name>.py, else of metrics/<name up to its dot>.py."""
    for stem in (name, name.split(".")[0]):
        path = here / "metrics" / f"{stem}.py"
        if path.is_file():
            return _module(path, f"portbench_metric_{stem}").read
    raise SystemExit(f"portbench: no reader for metric {name!r}")


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The cell's end-to-end metrics, or with `traced` its per-layer ones."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _warm_rare_path(mod, index, traffic: load.Traffic, allow, telem) -> None:
    """Search the pool in order at the batch size until a query takes the
    index module's rare path (RARE_COUNTER), for at most WARM_RARE_CALLS
    calls and one pass over the pool, so that the window meets no kernel
    the first time (CUDA loads a kernel at its first launch)."""
    counter = getattr(mod, "RARE_COUNTER", None)
    if counter is None:
        return
    b = traffic.batch
    telem.reset()
    telem.enable()
    try:
        for c in range(min(WARM_RARE_CALLS, -(-traffic.n_pool // b))):
            if telem.snapshot()["counters"].get(counter, 0):
                break
            mod.search(index, traffic.slice(c * b, b), traffic.k, allow)
    finally:
        telem.disable()
        telem.reset()


def _window(mod, index, run: Run, traffic: load.Traffic, seconds: float, allow,
            prof=None, launches: Callable[[], int] = lambda: 0, pending: Optional[list] = None) -> list:
    """The mix's calls for `seconds`; returns the kept calls as (first
    position, queries, result). `prof`, a torch.profiler profile or None,
    records the window's first TRACE_SECONDS; run.trace_s gets the seconds
    it recorded and run.trace_launches the scan's launches in them.
    `pending`, where given, is the list TELEM's recorder appends a call's
    QueryStats to."""
    from torch.profiler import record_function

    kept, errors, failed = [], [], [0]
    traced = prof is not None
    launches0 = launches() if traced else 0
    if traced:
        prof.start()
    t0 = time.perf_counter()

    def call(start: int, n: int) -> float:
        nonlocal traced
        t = time.perf_counter()
        try:
            with record_function("portbench.call") if traced else nullcontext():
                res = mod.search(index, traffic.slice(start, n), traffic.k, allow)
        except Exception:  # a failed call is counted and the loop goes on
            res = None
            failed[0] += n
            if not errors:
                errors.append(traceback.format_exc())
        t1 = time.perf_counter()
        i = len(run.call_s)
        run.call_s.append(t1 - t)
        run.sizes.append(n)
        if pending is not None:
            stages, flags = {}, set()
            for st in pending:
                for name, ms in st.stage_ms.items():
                    stages[name] = stages.get(name, 0.0) + ms
                flags |= set(st.flags)
            pending.clear()
            run.stage_ms.append(stages)
            run.flags.append(flags)
        if i < load.MAX_CALLS and traffic.keep[i]:
            kept.append((start, n, res))
        if traced and (t1 - t0 >= TRACE_SECONDS or t1 - t0 >= seconds):
            run.trace_s, traced = t1 - t0, False
            prof.stop()
            run.trace_launches = launches() - launches0
        return t1

    b = traffic.batch
    if traffic.loop == "closed":
        i = 0
        while True:
            t1 = call(i * b, b)
            run.latency_s.append(run.call_s[-1])
            i += 1
            if t1 - t0 >= seconds:
                break
        run.attempted = sent = i * b
    else:
        arrive = traffic.arrival_times(seconds)
        i, t1 = 0, t0
        while i < len(arrive):
            now = time.perf_counter() - t0
            if now >= seconds + DRAIN_SECONDS:
                break
            if arrive[i] > now:
                time.sleep(arrive[i] - now)
                continue
            j = min(len(arrive), i + b, int(np.searchsorted(arrive, now, side="right")))
            t1 = call(i, j - i)
            run.latency_s.extend((t1 - t0) - arrive[i:j])
            i = j
        run.attempted, sent = len(arrive), i
    if traced:
        prof.stop()
        run.trace_s, run.trace_launches = t1 - t0, launches() - launches0
    run.calls, run.wall_s = len(run.call_s), t1 - t0
    run.queries = sent - failed[0]
    run.failed = run.attempted - run.queries
    for e in errors:
        print(f"portbench: first failed call:\n{e}", file=sys.stderr)
    return kept


def _answers(mod, kept: list, traffic: load.Traffic) -> list:
    out = []
    for start, n, res in kept:
        rows = mod.pairs(res) if res is not None else []
        for j, qi in enumerate(traffic.query_index(start, n)):
            out.append((int(qi), rows[j] if j < len(rows) else None))
    return out


def _check(mod, cfg: dict, rows, queries, kept, traffic: load.Traffic, device) -> tuple:
    form = mod.ANSWER
    answers = _answers(mod, kept, traffic)
    if not answers:
        return False, {n: {"value": None, "limit": cfg["limits"].get(n)} for n in compare.FORMS[form]}
    allowed = None
    if traffic.allow is not None:
        allowed = np.zeros(rows.shape[0], dtype=bool)
        allowed[traffic.allow] = True
    qidx, ids, scores = compare.answer_arrays(answers, traffic.k, rows.shape[0], allowed)
    uniq, inv = np.unique(qidx, return_inverse=True)
    ref_ids, ref_dist = compare.reference_topk(rows, queries[uniq], cfg, device, allowed=allowed,
                                               k=traffic.k)
    found = compare.numbers(rows, queries, cfg, qidx, ids, scores, (ref_ids[inv], ref_dist[inv]),
                            device, form)
    print(f"portbench: checked {len(answers)} answers of {len(kept)} calls, "
          f"{len(uniq)} distinct queries, in the {form!r} form", file=sys.stderr)
    return compare.judge(found, cfg["limits"])


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, here: Path = HERE) -> dict:
    """One run of a cell; returns the result line as a dict."""
    from vectorindex_tpu_torch.kernels import scan_fused
    from vectorindex_tpu_torch.utils.telemetry import TELEM

    cell = find(bench["workloads"], cell_name, "workload")
    cfg, mix = load_config(cell["config"], here), load_mix(cell["traffic"], here)
    load.validate(mix)
    mod = index_module(cfg, here)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    rows, queries = data.make(cfg, seed, device)
    traffic = load.make(mix, cfg, queries, seed)
    run = Run(cfg=cfg, kind=kind, batch=traffic.batch, k=traffic.k)
    allow = None if traffic.allow is None else traffic.allow.tolist()
    if hasattr(mod, "prime"):
        mod.prime(cfg, traffic.batch, traffic.k, device, rows)
        if cuda:
            torch.cuda.synchronize(device)
    t = time.perf_counter()
    index = mod.build(cfg, rows, device)
    mod.search(index, traffic.slice(0, traffic.batch), traffic.k, allow)
    run.insert_s = time.perf_counter() - t
    for n in load.warm_sizes(traffic):
        for _ in range(WARM_CALLS - (n == traffic.batch)):
            mod.search(index, traffic.slice(0, n), traffic.k, allow)
    _warm_rare_path(mod, index, traffic, allow, TELEM)
    if cuda:
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t_start

    prof, pending = None, None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        pending = []
        TELEM.reset()
        TELEM.enable()
        TELEM.register_recorder("portbench", pending.append)
        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    try:
        kept = _window(mod, index, run, traffic, seconds, allow, prof,
                       lambda: scan_fused.LAUNCHES["bin_candidates"] + scan_fused.LAUNCHES["count_below"],
                       pending)
    finally:
        if traced:
            TELEM.disable()
            TELEM.unregister_recorder("portbench")
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if traced:
        run.counters = dict(TELEM.snapshot()["counters"])
        summary = tracing.summarize(prof.events())
        run.trace = {"busy_s": summary["busy_s"], "window_s": run.trace_s}
        print(f"portbench: trace of the window's first {run.trace_s:.6f} s: "
              f"{summary['scan_kernels']} scan kernels in the profiler, {run.trace_launches} K1/K2 launches "
              f"counted over the same calls; rare path over the window "
              f"{run.counters.get(getattr(mod, 'RARE_COUNTER', ''), 0)} queries", file=sys.stderr)
        prof = None
    del index
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    lat = run.latency_s
    q = statistics.quantiles(lat, n=20) if len(lat) > 1 else lat * 19
    print(f"portbench: {run.calls} calls, {run.queries} queries answered of {run.attempted} in "
          f"{run.wall_s:.6f} s; latency over {len(lat)} requests: median "
          f"{statistics.median(lat) * 1e3:.6f} ms, p95 {q[18] * 1e3:.6f} ms; setup {run.setup_s:.6f} s, "
          f"inserts and first search {run.insert_s:.6f} s", file=sys.stderr)

    metrics = {}
    for m in cell_metrics(bench, cell_name, traced):
        got = metric_reader(m["name"], here)(run)
        if isinstance(got, tuple):
            got, note = got
            print(f"portbench: {m['name']}: {note}", file=sys.stderr)
        if got is not None:
            metrics[m["name"]] = {"value": got, "unit": m["unit"]}

    ok, checks = _check(mod, cfg, rows, queries, kept, traffic, device)
    result = {
        "correct": bool(ok and run.failed == 0),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(memory_peak)},
    }
    if traced:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="portbench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark(HERE.parent)
    cell = find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the run may not load: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0
