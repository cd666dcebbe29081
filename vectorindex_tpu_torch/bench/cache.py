"""Disk cache for expensive benchmark build artifacts (numpy only; the
port's own copy of the JAX package's `bench/cache`).

A repeat benchmark run skips its builds (k-means quantizers, PQ state,
graphs, large corpora) by loading them from a content-keyed artifact
cache. Artifacts are numpy .npz bundles, keyed by an explicit config string
that includes every parameter affecting the artifact plus a generator
version. Scalars (e.g. the build seconds measured when the artifact was
first built) ride along as 0-d arrays, so warm runs can report the true,
reproducible build cost instead of the cache's load time.

The port's artifacts live apart from the JAX package's: in the `torch/`
subdirectory of the directory both packages compute (`<repo>/.benchcache`,
or `$VECTORINDEX_BENCH_CACHE`). A key such as a trained quantizer names
different arrays in the two packages (their k-means draw from different
generators), so neither package may read the other's file under one key.

Arrays above _MMAP_THRESHOLD bytes are persisted as raw .npy sidecars and
handed back as read-only np.memmap views: a memmap open is O(1) and pages
in only what a consumer touches, where an uncompressed-npz reload copies
the whole array through the zip layer. The sidecars are written before the
.npz, and the .npz's presence gates an artifact's validity, so a killed run
never leaves a readable but partial artifact.
"""

from __future__ import annotations

import os
import time
import zipfile
from typing import Callable, Dict

import numpy as np

_ENV = "VECTORINDEX_BENCH_CACHE"
#: the port's subdirectory of the shared cache directory
SUBDIR = "torch"
_MMAP_THRESHOLD = int(
    os.environ.get("VECTORINDEX_BENCH_MMAP_BYTES", 128 << 20)
)
_MMAP_INDEX_KEY = "__mmap_names__"


def cache_dir() -> str:
    d = os.environ.get(_ENV)
    if not d:
        d = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".benchcache")
    d = os.path.join(d, SUBDIR)
    os.makedirs(d, exist_ok=True)
    return d


def _sidecar(key: str, name: str) -> str:
    return os.path.join(cache_dir(), f"{key}__{name}.npy")


def cached(
    key: str, builder: Callable[[], Dict[str, np.ndarray]]
) -> tuple[Dict[str, np.ndarray], bool]:
    """(artifact dict, was_cached). builder() runs once per key; its dict of
    arrays is persisted and replayed on subsequent calls. A 'build_s' scalar
    recording the builder's wall-clock is added if the builder didn't.
    Arrays >_MMAP_THRESHOLD bytes come back as read-only memmap views."""
    path = os.path.join(cache_dir(), key + ".npz")
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                out = {k: z[k] for k in z.files if k != _MMAP_INDEX_KEY}
                names = (
                    [str(s) for s in z[_MMAP_INDEX_KEY]]
                    if _MMAP_INDEX_KEY in z.files else []
                )
            for name in names:
                out[name] = np.load(_sidecar(key, name), mmap_mode="r")
            return out, True
        except (OSError, ValueError, EOFError, zipfile.BadZipFile):
            os.remove(path)  # half-written/stale cache from a killed run
    t0 = time.perf_counter()
    arrs = builder()
    build_s = time.perf_counter() - t0
    arrs = dict(arrs)
    arrs.setdefault("build_s", np.float64(build_s))
    small, big = {}, {}
    for name, a in arrs.items():
        a = np.asarray(a)
        (big if a.nbytes > _MMAP_THRESHOLD else small)[name] = a
    # sidecars first: the .npz (written last, atomically) gates validity
    for name, a in big.items():
        tmp = _sidecar(key, name) + ".tmp.npy"
        np.save(tmp, a)
        os.replace(tmp, _sidecar(key, name))
    if big:
        small[_MMAP_INDEX_KEY] = np.array(sorted(big), dtype=np.str_)
    tmp = path + ".tmp.npz"  # .npz suffix so np.savez doesn't append one
    np.savez(tmp, **small)
    os.replace(tmp, path)
    for name in big:  # hand back memmap views, same as a warm load
        arrs[name] = np.load(_sidecar(key, name), mmap_mode="r")
    return arrs, False
