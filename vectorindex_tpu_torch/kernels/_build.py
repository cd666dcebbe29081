"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu   # one per file
    nvcc -shared -o <cache>/libvectorindex_kernels.so <tmp>/*.o

The library goes to `build/kernels/<hash>/` under the repository root (a
directory .gitignore lists), keyed by a hash of the sources and flags, so an
edit to a source rebuilds and nothing is ever written into the package. The
build runs at first use; importing this module does nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libvectorindex_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = str(Path(tmp) / f"{src.stem}.o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        # wait for every compile, then report all that failed
        logs = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
        failed = [f"{src} ({rc}):\n{log}" for src, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = str(Path(tmp) / LIB_NAME)
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a reader never sees a partial library
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vi_bin_candidates.argtypes = [p, p, p, p] + [i] * 10 + [p, p, p, p, p]
    lib.vi_bin_candidates.restype = ctypes.c_int
    lib.vi_bin_candidates_tree.argtypes = [p, p, p] + [i] * 10 + [p, p, p, p, p]
    lib.vi_bin_candidates_tree.restype = ctypes.c_int
    lib.vi_count_below.argtypes = [p, p, p, p, p] + [i] * 10 + [p, p, p]
    lib.vi_count_below.restype = ctypes.c_int
    lib.vi_ivf_probe_scores.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p, p]
    lib.vi_ivf_probe_scores.restype = ctypes.c_int
    lib.vi_ivf_probe_topc.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p]
    lib.vi_ivf_probe_topc.restype = ctypes.c_int
    lib.vi_adc_probe_scores.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p, p]
    lib.vi_adc_probe_scores.restype = ctypes.c_int
    lib.vi_adc_scan.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p, p]
    lib.vi_adc_scan.restype = ctypes.c_int
    lib.vi_adc_topk_candidates.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.vi_adc_topk_candidates.restype = ctypes.c_int
    lib.vi_error_string.argtypes = [i]
    lib.vi_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.vi_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
