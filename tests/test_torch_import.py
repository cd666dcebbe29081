"""vectorindex_tpu_torch imports without JAX and without a CUDA toolchain, and
its jax-free copies and ports agree with the JAX package's modules."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vectorindex_tpu_torch"

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import vectorindex_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
from vectorindex_tpu_torch.kernels import _build
from vectorindex_tpu_torch.persistence import container
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m.split(".")[0] == "vectorindex_tpu"),
    "ml_dtypes": sorted(m for m in sys.modules if m.split(".")[0] == "ml_dtypes"),
    "library_loaded": _build._lib is not None or container._lib is not None,
}))
"""


def test_every_module_imports_without_jax_or_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # no nvcc anywhere on PATH
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["jax"] == [] and got["reference"] == [] and got["ml_dtypes"] == []
    assert not got["library_loaded"]  # building waits for the first launch or open
    expected = {
        "vectorindex_tpu_torch.kernels.scan_fused",
        "vectorindex_tpu_torch.kernels.ivf_probe",
        "vectorindex_tpu_torch.kernels.adc_probe",
        "vectorindex_tpu_torch.kernels.adc",
        "vectorindex_tpu_torch.kernels._build",
        "vectorindex_tpu_torch.models.flat",
        "vectorindex_tpu_torch.models.ivf",
        "vectorindex_tpu_torch.models.hnsw",
        "vectorindex_tpu_torch.ops.graph",
        "vectorindex_tpu_torch.ops.ivf",
        "vectorindex_tpu_torch.ops.ivf_pq",
        "vectorindex_tpu_torch.ops.pq",
        "vectorindex_tpu_torch.ops.dtypes",
        "vectorindex_tpu_torch.ops.dedup",
        "vectorindex_tpu_torch.ops.kmeans",
        "vectorindex_tpu_torch.ops.range_query",
        "vectorindex_tpu_torch.ops.reservoir",
        "vectorindex_tpu_torch.ops.rng",
        "vectorindex_tpu_torch.ops.rerank",
        "vectorindex_tpu_torch.models.serve",
        "vectorindex_tpu_torch.ops.scan",
        "vectorindex_tpu_torch.persistence.json_snapshot",
        "vectorindex_tpu_torch.persistence.container",
        "vectorindex_tpu_torch.persistence.container_index",
        "vectorindex_tpu_torch.persistence.durable",
        "vectorindex_tpu_torch.utils.telemetry",
        "vectorindex_tpu_torch.utils.debug",
        "vectorindex_tpu_torch.ops.mips",
        "vectorindex_tpu_torch.ops.layout",
        "vectorindex_tpu_torch.models.typed",
        "vectorindex_tpu_torch.models.accel",
        "vectorindex_tpu_torch.models.sharded",
        "vectorindex_tpu_torch.parallel",
        "vectorindex_tpu_torch.parallel.mesh",
        "vectorindex_tpu_torch.parallel.sharded_search",
        "vectorindex_tpu_torch.parallel.sharded_ivf",
        "vectorindex_tpu_torch.parallel.sharded_hnsw",
        "vectorindex_tpu_torch.bench",
        "vectorindex_tpu_torch.bench.__main__",
        "vectorindex_tpu_torch.bench.cache",
        "vectorindex_tpu_torch.bench.datagen",
        "vectorindex_tpu_torch.bench.harness",
        "vectorindex_tpu_torch.bench.synth",
        "vectorindex_tpu_torch.bench.timing",
    }
    assert expected <= set(got["modules"])


def test_port_sources_use_no_jax_no_compile_no_fallback():
    banned = [
        re.compile(r"^\s*(import|from)\s+jax\b", re.M),
        re.compile(r"^\s*(import|from)\s+vectorindex_tpu(\.|\s)", re.M),
        re.compile(r"^\s*(import|from)\s+ml_dtypes\b", re.M),
        re.compile(r"torch\.compile"),
    ]
    # no except around a kernel launch: a CUDA tensor launches or raises
    launching = [
        *sorted((PORT / "kernels").glob("*.py")),
        PORT / "models" / "flat.py",
        PORT / "models" / "ivf.py",
    ]
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for pattern in banned:
            assert not pattern.search(text), f"{path.name}: {pattern.pattern}"
    # sharding is one process holding a list of devices
    distributed = re.compile(r"(import|from)\s+torch\.distributed|torch\.distributed\.\w+\(")
    for path in [*sorted((PORT / "parallel").glob("*.py")), PORT / "models" / "sharded.py"]:
        assert not distributed.search(path.read_text()), path.name
    for path in launching:
        assert not re.search(r"^\s*except\b", path.read_text(), re.M), path.name


def test_build_cache_is_outside_the_package_and_keyed_by_source(tmp_path, monkeypatch):
    from vectorindex_tpu_torch.kernels import _build

    path = _build.library_path()
    assert path.is_relative_to(ROOT / "build" / "kernels")
    assert not path.is_relative_to(PORT)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_hostops_builds_under_build_from_the_ports_own_source(tmp_path, monkeypatch):
    """The native host rerank is built from the port's own copy of
    hostops.cpp into build/hostops/<hash of source, flags and CPU>/, never
    into the package; a failed build raises with the compiler's output."""
    from vectorindex_tpu_torch.ops import rerank as rr

    assert rr.HOSTOPS_SRC.is_relative_to(PORT) and rr.HOSTOPS_SRC.exists()
    ref = ROOT / "vectorindex_tpu" / "persistence" / "native" / "hostops.cpp"
    strip = lambda t: [ln for ln in t.splitlines() if not ln.startswith("//")]  # noqa: E731
    assert strip(rr.HOSTOPS_SRC.read_text()) == strip(ref.read_text())  # the same code
    path = rr.hostops_path()
    assert path.is_relative_to(ROOT / "build" / "hostops") and not path.is_relative_to(PORT)
    assert "-march=native" in rr.GXX_FLAGS
    src = tmp_path / "hostops.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(rr, "HOSTOPS_SRC", src)
    monkeypatch.setattr(rr, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(rr, "_lib", None)
    assert rr.hostops_path() != path
    monkeypatch.setattr(rr, "_cpu_key", lambda: "another cpu")
    assert rr.hostops_path() != path
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: "):
        rr.load_hostops()
    assert list((tmp_path / "build").rglob("*.so")) == []  # nothing half-built is left
    monkeypatch.setattr(rr.subprocess, "run", lambda *a, **k: (_ for _ in ()).throw(
        FileNotFoundError("g++")))
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        rr.load_hostops()


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    import torch.utils.cpp_extension as cpp

    from vectorindex_tpu_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_copied_modules_match_the_reference():
    from vectorindex_tpu.utils import config as jconfig
    from vectorindex_tpu.utils import errors as jerrors
    from vectorindex_tpu_torch.utils import config, errors

    assert [m.value for m in config.Metric] == [m.value for m in jconfig.Metric]
    assert [(k.name, k.slug, k.category.value, k.recoverable) for k in errors.IndexErrorKind] == [
        (k.name, k.slug, k.category.value, k.recoverable) for k in jerrors.IndexErrorKind
    ]
    assert jconfig.ScoreOpts().__dict__ == config.ScoreOpts().__dict__


def test_telemetry_records_like_the_reference():
    from vectorindex_tpu.utils.telemetry import Telemetry as JTelemetry
    from vectorindex_tpu_torch.utils.telemetry import QueryStats, Telemetry

    snaps = []
    for cls in (JTelemetry, Telemetry):
        t = cls(enabled=True)
        stats = QueryStats(batch=4) if cls is Telemetry else None
        with t.timer("score_flat", stats):
            pass
        t.inc("flat.verify_fallback", 2)
        t.add_bytes("vecs", 512)
        t.record_kernel("scan_fused", rows=10, bytes=512)
        snap = t.snapshot()
        snaps.append((sorted(snap), sorted(snap["counters"]), snap["bytes"]))
        if stats is not None:
            assert "score_flat" in stats.stage_ms
    assert snaps[0] == snaps[1]
    off = Telemetry(enabled=False)
    with off.timer("score_flat"):
        pass
    off.record_kernel("scan_fused")
    assert off.snapshot()["counters"] == {}


def test_ivf_layout_constants_match_the_reference():
    """The CSR row layout (block size, guard blocks, list capacities) and the
    K3 route are the JAX package's, so a CSR row means the same in both."""
    from vectorindex_tpu.kernels import ivf_probe as jkp
    from vectorindex_tpu.models.ivf import IVFConfig as JConfig
    from vectorindex_tpu_torch.kernels import ivf_probe as kp
    from vectorindex_tpu_torch.models.ivf import IVFConfig

    assert (kp.BLK, kp.CBINS, kp.GUARD_BLOCKS) == (jkp.BLK, jkp.CBINS, jkp.GUARD_BLOCKS)
    for b in (0, 1, 8, 16, 17, 256):
        assert kp.rank_major_fits(b, 4096, 128, 2) == jkp.rank_major_fits(b, 4096, 128, 2)
    assert IVFConfig().__dict__ == JConfig().__dict__
    text = (PORT / "kernels" / "csrc" / "ivf_probe.cu").read_text()
    for name in ("ivf_probe_scores", "ivf_probe_scores_rankmajor", "ivf_probe_topc_rankmajor"):
        assert f"ivf_probe.py:{name}" in text  # the source names what it replaces


def test_ivfpq_constants_match_the_reference():
    """The K9/K10 route, the IVF-PQ config defaults and the source notes
    are the JAX package's."""
    from vectorindex_tpu.kernels import adc_probe as jap
    from vectorindex_tpu.models.ivf import IVFPQConfig as JConfig
    from vectorindex_tpu_torch import IVFPQConfig
    from vectorindex_tpu_torch.kernels import adc_probe as ap

    for b in (0, 1, 8, 16, 17, 256):
        assert ap.adc_rankseg_fits(b) == jap.adc_rankseg_fits(b)
    assert IVFPQConfig().__dict__ == JConfig().__dict__
    text = (PORT / "kernels" / "csrc" / "adc_probe.cu").read_text()
    for name in ("adc_probe_scores", "adc_probe_scores_rankseg"):
        assert f"adc_probe.py:{name}" in text  # the source names what it replaces
