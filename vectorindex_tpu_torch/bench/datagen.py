"""Deterministic benchmark data generation (numpy only; the port's own copy
of the JAX package's `bench/datagen`, so both give the same bytes from the
same seed).

Parity target: reference DataGen (VectorIndexBenchmarks/main.swift:390-404)
— seeded LCG producing unit-normalized vectors, so runs are reproducible
without fixture files (SURVEY.md §4 'all data generated in-test with seeded
LCGs')."""

from __future__ import annotations

import numpy as np


def generate(n: int, d: int, seed: int = 42, normalized: bool = True) -> np.ndarray:
    """Seeded vector corpus [n, d] f32, unit-norm by default."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if normalized:
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    return x


def queries_from(x: np.ndarray, q: int, noise: float = 0.05, seed: int = 7) -> np.ndarray:
    """Queries near corpus points (controllable difficulty)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, x.shape[0], q)
    out = x[idx] + noise * rng.standard_normal((q, x.shape[1])).astype(np.float32)
    return out.astype(np.float32)


def generate_clustered(
    n: int,
    d: int,
    n_clusters: int = 1024,
    spread: float = 0.15,
    seed: int = 42,
    normalized: bool = True,
) -> np.ndarray:
    """Clustered corpus (SIFT-like local structure): IVF/graph recall on
    uniform random vectors is degenerate — real embedding corpora cluster,
    and meaningful recall/QPS tradeoffs need that structure."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    x = centers[assign] + spread * rng.standard_normal((n, d)).astype(np.float32)
    if normalized:
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# standard ANN dataset formats (SIFT1M/GIST1M/Deep1B distribution format)
# ---------------------------------------------------------------------------


def read_fvecs(path: str, max_rows: int | None = None) -> np.ndarray:
    """*.fvecs: per row an int32 dim header then dim float32s."""
    raw = np.fromfile(path, dtype=np.int32, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    d = int(raw[0])
    row_words = d + 1
    n = raw.size // row_words
    if max_rows is not None:
        n = min(n, max_rows)
    mat = raw[: n * row_words].reshape(n, row_words)
    if not (mat[:, 0] == d).all():
        raise ValueError(f"inconsistent fvecs dims in {path}")
    return mat[:, 1:].view(np.float32).copy()


def read_bvecs(path: str, max_rows: int | None = None) -> np.ndarray:
    """*.bvecs: per row an int32 dim header then dim uint8s → f32."""
    raw = np.fromfile(path, dtype=np.uint8, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    d = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    row_bytes = 4 + d
    n = raw.size // row_bytes
    if max_rows is not None:
        n = min(n, max_rows)
    mat = raw[: n * row_bytes].reshape(n, row_bytes)
    return mat[:, 4:].astype(np.float32)


def read_ivecs(path: str, max_rows: int | None = None) -> np.ndarray:
    """*.ivecs (ground-truth neighbor ids): int32 rows with dim headers."""
    raw = np.fromfile(path, dtype=np.int32, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.int32)
    d = int(raw[0])
    row_words = d + 1
    n = raw.size // row_words
    if max_rows is not None:
        n = min(n, max_rows)
    return raw[: n * row_words].reshape(n, row_words)[:, 1:].copy()


def write_fvecs(path: str, x: np.ndarray) -> None:
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = x.view(np.int32)
    out.tofile(path)
