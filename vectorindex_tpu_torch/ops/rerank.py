"""Exact rerank over an abstract vector source (the VectorReader seam).

Counterpart of vectorindex_tpu/ops/rerank.py (parity target: the reference's
ExactRerank.swift:81-96, whose rerank stage reads full-precision vectors
through a `VectorReader` protocol, a callback-backed reader included,
:211 CallbackReader).

The host-memory capacity tier is built on it: PQ codes, corrections and CSR
metadata (~24 B a row at pq16) stay on the card, the f32 corpus (384 B a row
at d = 96) stays in host RAM. The ADC probe (kernels/adc_probe) selects the
top-C candidates of each query on the card; only their ids cross to the host,
where the rows are reranked exactly.

Three rerank paths, each counted in `RERANK_IMPL` when it runs:
  - "native": `rerank_ids_host`, the fused gather + score + top-k of
    persistence/native/hostops.cpp (the port's own copy), loaded with ctypes
    (the call releases the GIL). It is built at first use with g++ into
    build/hostops/<hash>/ under the repository root, keyed by the source,
    the flags and the CPU (the code is -march=native); a failed build
    raises with the compiler's output.
  - "numpy": `rerank_gathered_host` over rows already gathered on the host.
    Taken only where the layout rules the native path out: a rows-keyed
    reader, a corpus that is not a row-contiguous f32 array, or queries wider
    than its rows.
  - "device": `rerank_gathered`, the same rerank in torch on the rows'
    device at full f32 (TF32 refused).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional, Protocol, Tuple

import numpy as np
import torch

from vectorindex_tpu_torch.ops.ivf import _gram_rows
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor

#: reranks per path since the last reset (one per query batch)
RERANK_IMPL = {"native": 0, "numpy": 0, "device": 0}


def reset_rerank_counts() -> None:
    for name in RERANK_IMPL:
        RERANK_IMPL[name] = 0


class VectorReader(Protocol):
    """Abstract full-precision vector source keyed by CSR row (reference
    VectorReader, ExactRerank.swift:81-96)."""

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """rows [K] int (CSR rows, already clipped to range) → [K, d] f32."""
        ...


class ArrayReader:
    """Host ndarray in CSR row order (row r holds the vector of CSR row r)."""

    def __init__(self, vecs: np.ndarray):
        self.vecs = np.ascontiguousarray(vecs, dtype=np.float32)

    def gather(self, rows: np.ndarray) -> np.ndarray:
        return self.vecs[rows]


class CSRReader:
    """Host ndarray in ORIGINAL row order and the CSR row_ids table: no
    second, CSR-ordered copy of a multi-GB corpus, and no f32 copy of an f32
    one."""

    #: `vecs` is indexed by original corpus id (vecs[id] is what
    #: gather_ids([id]) returns): the native rerank reads it directly. A
    #: reader whose `vecs` is in any other order must leave this False.
    vecs_id_indexed = True

    def __init__(self, vecs: np.ndarray, row_ids: np.ndarray):
        self.vecs = vecs
        self.row_ids = np.asarray(row_ids)

    def gather(self, rows: np.ndarray) -> np.ndarray:
        orig = self.row_ids[rows]
        return self.vecs[np.maximum(orig, 0)].astype(np.float32, copy=False)

    def gather_ids(self, ids: np.ndarray) -> np.ndarray:
        """Gather by original corpus id (the `iids` pq_probe_candidates
        returns). Out-of-range ids (INVALID_ID, the dead-slot -1) read row
        0; callers mask them by id."""
        safe = np.where((ids < 0) | (ids >= self.vecs.shape[0]), 0, ids)
        return self.vecs[safe].astype(np.float32, copy=False)


class CallbackReader:
    """Arbitrary gather callback: mmap'd files, remote storage, decoders
    (reference CallbackReader, ExactRerank.swift:211)."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self.fn = fn

    def gather(self, rows: np.ndarray) -> np.ndarray:
        return np.asarray(self.fn(rows), dtype=np.float32)


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------

HOSTOPS_SRC = Path(__file__).resolve().parents[1] / "persistence" / "native" / "hostops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "hostops"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++20", "-fPIC", "-shared")
LIB_NAME = "libvindex_hostops.so"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _cpu_key() -> str:
    """The machine and the stable identity lines of /proc/cpuinfo (model
    name, flags, vendor; not the volatile clock lines): -march=native code
    built on one CPU may not run on another."""
    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            stable = sorted({ln.strip() for ln in f
                             if ln.startswith(("model name", "flags", "vendor_id"))})
        key += "\n" + "\n".join(stable)
    except OSError:
        pass
    return key


def hostops_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(HOSTOPS_SRC.read_bytes())
    h.update(_cpu_key().encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _build_hostops() -> Path:
    """Compile into a temp file beside the target, then os.replace it into
    place (processes may race the build; none may load a half-written
    library). A failed build raises with the compiler's output."""
    out = hostops_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=".build_", dir=out.parent)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(HOSTOPS_SRC)],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"building {HOSTOPS_SRC.name} needs g++: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {HOSTOPS_SRC} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_hostops() -> ctypes.CDLL:
    """The native host-ops library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build_hostops()))
            lib.vi_rerank_ids_f32.restype = None
            lib.vi_rerank_ids_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
        return _lib


def host_threads() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


_METRIC_CODE = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}

_F32_EPS = float(np.finfo(np.float32).eps)


def _metric_code(metric: Metric) -> int:
    if metric not in _METRIC_CODE:
        raise ValueError(f"the exact rerank supports L2, IP and cosine, got {metric.value}")
    return _METRIC_CODE[metric]


def host_rerank_dist_tol(d: int, scale: float = 1.0) -> float:
    """The native ↔ numpy host-rerank parity contract (the JAX package's,
    settled in its round 5).

    The two host paths do the same f32 arithmetic in different reduction
    orders (hostops.cpp's 16-lane FMA trees against BLAS blocked sums), so
    distances are not bit-identical on real-valued data (on integer-valued
    data both are exact). What they do hold:

      1. each orders its results by strict (score, id) ascending, missing
         slots hold (+inf, INVALID_ID);
      2. every returned distance agrees within 8·d·eps_f32·scale, where
         `scale` is the magnitude of the terms before cancellation (max
         ‖q‖² + ‖x‖² for L2; O(1) for cosine);
      3. ids agree exactly wherever no two candidate scores of a query lie
         within that bound of each other."""
    return 8.0 * d * _F32_EPS * max(float(scale), 1.0)


def native_rerank_available(x) -> bool:
    """True when the corpus layout admits the native rerank: a 2-D f32
    ndarray whose rows are contiguous (a row stride of whole f32s ≥ d). The
    library itself is built at first use, and a failed build raises."""
    return (
        isinstance(x, np.ndarray)
        and x.ndim == 2
        and x.dtype == np.float32
        and x.strides[1] == 4
        and x.strides[0] % 4 == 0
        and x.strides[0] >= x.shape[1] * 4
    )


def rerank_ids_host(
    x: np.ndarray,  # [n, stride] f32 corpus in ORIGINAL row order
    iids: np.ndarray,  # [B, C] int32 original ids (INVALID_ID / -1 missing)
    q: np.ndarray,  # [B, d] f32, d <= stride
    *,
    k: int,
    metric: Metric,
    n_threads: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Fused native gather + score + strict (score, id) top-k over candidate
    ids (hostops.cpp; reference ExactRerank.swift:655 with gatherTile
    :21-64): one streaming pass over the candidate rows, no [B, C, d]
    intermediate, queries split over `n_threads` (default: every core this
    process may use). Same ids and order as the numpy path; distances within
    host_rerank_dist_tol.

    Returns None where the layout rules the native path out (see
    native_rerank_available, or queries wider than x): the caller gathers and takes
    rerank_gathered_host. Empty [B, 0] arrays for k ≤ 0."""
    code = _metric_code(metric)
    b = int(np.shape(iids)[0])
    if k <= 0:  # the native top-k buffer needs k >= 1
        return np.empty((b, 0), np.float32), np.empty((b, 0), np.int32)
    if not native_rerank_available(x):
        return None
    q = np.ascontiguousarray(q, dtype=np.float32)
    d = q.shape[1]
    if d > x.shape[1]:
        return None
    iids = np.ascontiguousarray(iids, dtype=np.int32)
    c = iids.shape[1]
    lib = load_hostops()
    out_d = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    lib.vi_rerank_ids_f32(
        x.ctypes.data, x.shape[0], d, x.strides[0] // 4, iids.ctypes.data, q.ctypes.data,
        b, c, k, code, n_threads if n_threads > 0 else host_threads(),
        out_d.ctypes.data, out_i.ctypes.data,
    )
    RERANK_IMPL["native"] += 1
    return out_d, out_i


def rerank_gathered_host(
    q: np.ndarray,  # [B, d] f32
    xg: np.ndarray,  # [B, C, d'] f32 gathered candidate rows, d' >= d
    iids: np.ndarray,  # [B, C] int32 ids (INVALID_ID / negative missing)
    *,
    k: int,
    metric: Metric,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact rerank on the host (numpy) → (dist [B, k] f32, ids [B, k]
    int32): missing candidates keep (+inf, INVALID_ID) and sort last; ties
    break strictly by (score, id) (reference TopK.swift:8-30). The same
    contract as the native path, which drops negative ids too."""
    code = _metric_code(metric)
    q = np.asarray(q, np.float32)
    b, c, d = xg.shape
    if q.shape[1] != d:  # a padded gather source: zero columns change nothing
        q = np.pad(q, ((0, 0), (0, d - q.shape[1])))
    missing = (iids == INVALID_ID) | (iids < 0)
    g = np.matmul(xg, q[:, :, None])[:, :, 0]
    if code == 0:
        qn = np.einsum("bd,bd->b", q, q, dtype=np.float32)
        sg = np.einsum("bcd,bcd->bc", xg, xg, dtype=np.float32)
        ex = np.maximum(qn[:, None] + sg - 2.0 * g, 0.0)
    elif code == 1:
        ex = -g
    else:
        qn = np.sqrt(np.maximum(np.einsum("bd,bd->b", q, q), 1e-30))
        xn = np.sqrt(np.maximum(np.einsum("bcd,bcd->bc", xg, xg), 1e-30))
        ex = 1.0 - g / (qn[:, None] * xn)
    ex = np.where(missing, np.float32(np.inf), ex).astype(np.float32)
    ii = np.where(missing, INVALID_ID, iids).astype(np.int32)
    kk = min(k, c)
    order = np.lexsort((ii, ex), axis=1)[:, :kk]  # primary key: the last array
    sd = np.take_along_axis(ex, order, axis=1)
    si = np.take_along_axis(ii, order, axis=1)
    si = np.where(np.isfinite(sd), si, INVALID_ID)
    if kk < k:
        sd = np.concatenate([sd, np.full((b, k - kk), np.inf, np.float32)], axis=1)
        si = np.concatenate([si, np.full((b, k - kk), INVALID_ID, np.int32)], axis=1)
    RERANK_IMPL["numpy"] += 1
    return sd, si


def rerank_gathered(
    q: Tensor,  # [B, d] f32
    xg: Tensor,  # [B, C, d'] f32 gathered candidate rows, d' >= d
    cand_dist: Tensor,  # [B, C] f32 approximate distances (+inf missing)
    iids: Tensor,  # [B, C] int32 ids (INVALID_ID missing)
    *,
    k: int,
    metric: Metric,
) -> Tuple[Tensor, Tensor]:
    """Exact f32 rerank on the rows' device + strict (score, id) top-k →
    (dist [B, k], ids [B, k] int32). Missing candidates (non-finite
    cand_dist) keep (+inf, INVALID_ID) and sort last."""
    code = _metric_code(metric)
    b, c, d = xg.shape
    q = q.float()
    xg = xg.float()
    if q.shape[1] != d:
        q = torch.nn.functional.pad(q, (0, d - q.shape[1]))
    missing = ~torch.isfinite(cand_dist)
    g = _gram_rows(q, xg)
    if code == 0:
        qn = (q * q).sum(dim=-1)
        ex = torch.clamp_min(qn[:, None] + (xg * xg).sum(dim=-1) - 2.0 * g, 0.0)
    elif code == 1:
        ex = -g
    else:
        qn = torch.sqrt(torch.clamp_min((q * q).sum(dim=-1), 1e-30))
        xn = torch.sqrt(torch.clamp_min((xg * xg).sum(dim=-1), 1e-30))
        ex = 1.0 - g / (qn[:, None] * xn)
    ex = torch.where(missing, INVALID_DIST, ex)
    ii = torch.where(missing, INVALID_ID, iids.to(torch.int32))
    kk = min(k, c)
    sd, si = topk(ex, kk, ids=ii, strict_ties=True)
    if kk < k:
        sd = torch.cat([sd, sd.new_full((b, k - kk), INVALID_DIST)], dim=1)
        si = torch.cat([si, si.new_full((b, k - kk), INVALID_ID)], dim=1)
    RERANK_IMPL["device"] += 1
    return sd, si
