"""Dtype conversion and quantization helpers.

Counterpart of vectorindex_tpu.ops.dtypes (parity targets: reference S2
dtype half, S2_RNGDtype.swift:386-652, and CPQEncode's u4 bulk pack,
pq_encode.c:452-468). torch casts round to nearest even, as the reference's
software conversions and XLA's casts do.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def f32_to_bf16(x: Tensor) -> Tensor:
    """Round-to-nearest-even f32→bf16 (reference f32ToBF16Batch,
    S2_RNGDtype.swift:470)."""
    return x.to(torch.bfloat16)


def bf16_to_f32(x: Tensor) -> Tensor:
    return x.float()


def f32_to_f16(x: Tensor) -> Tensor:
    """RTNE f32→f16 with overflow→inf semantics (reference f32ToF16Batch,
    S2_RNGDtype.swift:386)."""
    return x.to(torch.float16)


def f16_to_f32(x: Tensor) -> Tensor:
    return x.float()


# ---------------------------------------------------------------------------
# int8 quantization (reference quantizeSymmetric/Affine, S2_RNGDtype.swift:522-587)
# ---------------------------------------------------------------------------


def _reduce(x: Tensor, fn, axis):
    return fn(x) if axis is None else fn(x, dim=axis, keepdim=True)


def quantize_symmetric_i8(x: Tensor, axis=None) -> Tuple[Tensor, Tensor]:
    """Symmetric int8: q = round(x/scale), scale = max|x|/127 (per-axis if
    given). Returns (codes i8, scale f32). Saturating like the reference."""
    absmax = _reduce(x.abs(), torch.amax, axis)
    scale = torch.clamp_min(absmax, 1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_symmetric_i8(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def quantize_affine_i8(x: Tensor, axis=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Affine int8: q = round(x/scale) + zp mapping [min,max] → [-128,127].
    Returns (codes i8, scale f32, zero_point i32)."""
    lo = _reduce(x, torch.amin, axis)
    hi = _reduce(x, torch.amax, axis)
    rng = hi - lo
    # degenerate (constant) range: scale = |v|/127 reconstructs the constant
    # exactly instead of overflowing the zero point
    degen = rng <= 0
    scale = torch.where(
        degen,
        torch.clamp_min(hi.abs(), 1e-12) / 127.0,
        torch.clamp_min(rng, 1e-30) / 255.0,
    )
    zp = torch.where(degen, 0.0, torch.round(-128.0 - lo / scale)).to(torch.int32)
    q = torch.clamp(torch.round(x / scale) + zp, -128, 127).to(torch.int8)
    return q, scale.float(), zp


def dequantize_affine_i8(q: Tensor, scale: Tensor, zp: Tensor) -> Tensor:
    return (q.to(torch.int32) - zp).float() * scale


# ---------------------------------------------------------------------------
# u4 nibble packing (reference nibble pack S2_RNGDtype.swift:632-652;
# CPQEncode u4 bulk pack pq_encode.c:452-468: even index → low nibble)
# ---------------------------------------------------------------------------


def pack_u4(codes: Tensor) -> Tensor:
    """Pack u4 codes (values 0..15, last axis even-length) into bytes.
    codes[..., 2i] → low nibble, codes[..., 2i+1] → high nibble (the
    reference's pairing contract, cpq_encode.h u4 pack)."""
    if codes.shape[-1] % 2:
        raise ValueError("u4 pack requires an even last axis")
    c = codes.to(torch.uint8)
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_u4(packed: Tensor) -> Tensor:
    """Inverse of pack_u4: bytes → u4 codes with 2× last-axis length."""
    p = packed.to(torch.uint8)
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
