"""Layout transforms: padding, interleave/deinterleave, PQ code blocking.

Counterpart of vectorindex_tpu.ops.layout, a copy of that numpy module
(parity target: the reference's Operations/Support/LayoutTransforms.swift —
AoS ↔ AoSoA register blocking for vectors, vecsInterleave_f32 :175 and
vecsDeinterleave_f32 :284 with RowBlockSize r4-r64 :20, PQ code interleave
pqCodesInterleave_u8/u4 :388-576 with PQGroupSize g4-g32 :32,
paddedDimension :86).

No search path calls these: they exist for API parity and for byte-exact
interop with buffers laid out by other runtimes. LANE = 128 stays the
default multiple of `padded_dimension`: it is a value callers see, so the
outputs equal the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

LANE = 128  # the JAX package's default multiple (the reference pads to 16 for NEON)
SUBLANE = 8


def padded_dimension(d: int, multiple: int = LANE) -> int:
    """Round a feature dim up to the hardware tile multiple (reference
    paddedDimension, LayoutTransforms.swift:86)."""
    return (d + multiple - 1) // multiple * multiple


def pad_rows_to(x: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Zero-pad rows to a multiple; returns (padded, original_n)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.zeros((rem,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, pad], axis=0), n


def vecs_interleave(x: np.ndarray, r: int = 8) -> np.ndarray:
    """AoS [n, d] → AoSoA [n/r, d, r] row blocking (reference
    vecsInterleave_f32 with RowBlockSize). n must be a multiple of r
    (pad_rows_to first)."""
    n, d = x.shape
    assert n % r == 0, f"n={n} not a multiple of r={r}"
    return np.ascontiguousarray(x.reshape(n // r, r, d).transpose(0, 2, 1))


def vecs_deinterleave(blocked: np.ndarray) -> np.ndarray:
    """Inverse of vecs_interleave: [n/r, d, r] → [n, d]."""
    nb, d, r = blocked.shape
    return np.ascontiguousarray(blocked.transpose(0, 2, 1).reshape(nb * r, d))


def pq_codes_interleave(codes: np.ndarray, g: int = 8) -> np.ndarray:
    """PQ codes [n, m] → group-blocked [n/g, m, g] (reference
    pqCodesInterleave_u8 with PQGroupSize; the layout ADC kernels read a
    group of g rows per subspace contiguously)."""
    n, m = codes.shape
    assert n % g == 0, f"n={n} not a multiple of g={g}"
    return np.ascontiguousarray(codes.reshape(n // g, g, m).transpose(0, 2, 1))


def pq_codes_deinterleave(blocked: np.ndarray) -> np.ndarray:
    """Inverse: [n/g, m, g] → [n, m]."""
    nb, m, g = blocked.shape
    return np.ascontiguousarray(blocked.transpose(0, 2, 1).reshape(nb * g, m))
