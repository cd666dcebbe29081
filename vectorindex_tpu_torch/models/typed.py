"""Typed vector overloads: array-protocol interop.

Counterpart of vectorindex_tpu.models.typed (parity target: the reference's
TypedOverloads.swift:6-24 and VectorReferenceCollection.swift's typed views).

A `VectorLike` protocol (anything exposing __array__, or a sequence of
floats) and the `as_vector` / `as_matrix` adapters. They take numpy arrays,
torch CPU tensors, array.array, memoryview and plain sequences. A tensor on
another device (CUDA) is refused with INVALID_VECTOR, the error of a failed
conversion: the caller moves it to the host, nothing moves it silently.
"""

from __future__ import annotations

from typing import Any, Protocol, Sequence, Union, runtime_checkable

import numpy as np

from vectorindex_tpu_torch.utils.errors import (
    ErrorBuilder,
    IndexErrorKind,
    dimension_mismatch,
)


@runtime_checkable
class VectorLike(Protocol):
    """Anything convertible to a 1-D float vector."""

    def __array__(self) -> Any: ...  # pragma: no cover - protocol


VectorInput = Union[VectorLike, Sequence[float], bytes, memoryview]


def _refuse_device_tensor(v) -> None:
    device = getattr(v, "device", None)
    if device is not None and getattr(device, "type", "cpu") != "cpu":
        raise (
            ErrorBuilder(IndexErrorKind.INVALID_VECTOR)
            .message(f"cannot convert a tensor on {device} to a float vector: move it "
                     "to the host first")
            .build()
        )


def as_vector(v: VectorInput, dimension: int | None = None) -> np.ndarray:
    """Normalize any vector-like input to a contiguous f32 [d] array.
    Torch tensors are accepted through __array__ on the CPU only."""
    _refuse_device_tensor(v)
    try:
        arr = np.asarray(v, dtype=np.float32).reshape(-1)
    except (TypeError, ValueError) as e:
        raise (
            ErrorBuilder(IndexErrorKind.INVALID_VECTOR)
            .message(f"cannot convert {type(v).__name__} to a float vector")
            .caused_by(e)
            .build()
        )
    if dimension is not None and arr.shape[0] != dimension:
        raise dimension_mismatch(dimension, arr.shape[0], "as_vector")
    return np.ascontiguousarray(arr)


def as_matrix(vs, dimension: int | None = None) -> np.ndarray:
    """Normalize a batch of vector-likes to f32 [n, d]."""
    _refuse_device_tensor(vs)
    try:
        arr = np.asarray(vs, dtype=np.float32)
    except (TypeError, ValueError):
        arr = np.stack([as_vector(v) for v in vs])
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise (
            ErrorBuilder(IndexErrorKind.INVALID_VECTOR)
            .message(f"expected 2-D batch, got ndim={arr.ndim}")
            .build()
        )
    if dimension is not None and arr.shape[1] != dimension:
        raise dimension_mismatch(dimension, arr.shape[1], "as_matrix")
    return np.ascontiguousarray(arr)
