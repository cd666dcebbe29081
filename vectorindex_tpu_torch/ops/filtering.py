"""ID filtering: bitsets over internal ids, allow/deny modes.

Parity targets (reference kernel #08):
  - IDFilterBitset                  Operations/Filtering/IDFilter.swift:16
  - idFilterPass/Mask/Compact       IDFilter.swift:123-323
  - IDFilterOverlay (base+delta)    IDFilter.swift:363
  - FilterMode allow/deny           IDFilter.swift:104

Counterpart of vectorindex_tpu.ops.filtering. A bitset is a 1-D tensor of
packed 32-bit words (bit i of word w is id 32*w + i, the JAX package's
layout). PyTorch has no shift or index ops for uint32, so the words are held
in int64 with values in [0, 2^32); `np.uint32` views of the JAX words compare
equal element for element. Search paths consume filters as dense boolean
masks fused into top-k padding.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

WORD_BITS = 32
_WORD_MASK = (1 << WORD_BITS) - 1


class FilterMode(enum.Enum):
    ALLOW = "allow"  # only ids in the set pass
    DENY = "deny"  # ids in the set are rejected


def bitset_size_words(n: int) -> int:
    return (n + WORD_BITS - 1) // WORD_BITS


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def _pack(mask: torch.Tensor) -> torch.Tensor:
    """Dense bool mask [n] -> packed words [ceil(n/32)] int64."""
    n = mask.shape[0]
    nw = bitset_size_words(n)
    bits = torch.zeros(nw * WORD_BITS, dtype=torch.int64, device=mask.device)
    bits[:n] = mask.to(torch.int64)
    return (bits.view(nw, WORD_BITS) << _shifts(mask.device)).sum(dim=1)


def bitset_from_ids(ids, n: int, device="cuda") -> torch.Tensor:
    """Build a packed bitset [ceil(n/32)] from a host list/array of ids, on
    `device` (the card unless the caller asks for the CPU, as the JAX
    counterpart returns a device array)."""
    ids = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    if ids.numel():
        mask[ids] = True
    return _pack(mask)


def bitset_test(bitset: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Vectorized membership test -> bool tensor shaped like `ids`."""
    ids = ids.to(torch.int64)
    word = bitset[ids // WORD_BITS]
    return ((word >> (ids % WORD_BITS)) & 1).to(torch.bool)


def bitset_set(bitset: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Functional set: returns a new bitset with `ids` bits on. Several ids
    in one word all land (the words are OR-ed, not overwritten)."""
    n = bitset.shape[0] * WORD_BITS
    return bitset | bitset_from_ids(ids.cpu().numpy(), n, device=bitset.device)


def bitset_to_mask(bitset: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack to a dense bool mask [n] — the form search pipelines fuse into
    top-k padding."""
    bits = (bitset[:, None] >> _shifts(bitset.device)[None, :]) & 1
    return bits.to(torch.bool).reshape(-1)[:n]


def bitset_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def bitset_intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def bitset_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & (~b & _WORD_MASK)


class IDFilterOverlay:
    """Base set + delta adds/removes composed lazily (reference
    IDFilterOverlay, IDFilter.swift:363)."""

    def __init__(self, base: torch.Tensor, mode: FilterMode = FilterMode.ALLOW):
        self.base = base
        self.mode = mode
        self.added: Optional[torch.Tensor] = None
        self.removed: Optional[torch.Tensor] = None

    def add(self, ids, n: int) -> "IDFilterOverlay":
        delta = bitset_from_ids(ids, n, device=self.base.device)
        self.added = delta if self.added is None else self.added | delta
        return self

    def remove(self, ids, n: int) -> "IDFilterOverlay":
        delta = bitset_from_ids(ids, n, device=self.base.device)
        self.removed = delta if self.removed is None else self.removed | delta
        return self

    def effective(self) -> torch.Tensor:
        out = self.base
        if self.added is not None:
            out = out | self.added
        if self.removed is not None:
            out = bitset_difference(out, self.removed)
        return out

    def allow_mask(self, n: int) -> torch.Tensor:
        """Dense allow mask [n]: True = candidate passes."""
        member = bitset_to_mask(self.effective(), n)
        return member if self.mode == FilterMode.ALLOW else ~member


def slot_mask_np(
    n: int,
    idmap,
    allow_ids=None,
    deny_ids=None,
) -> Optional[np.ndarray]:
    """Host-side allow mask [n] over internal slots from EXTERNAL id sets
    (the form index search paths consume; reference FilterMode allow/deny,
    IDFilter.swift:104). Unknown external ids are ignored — an allow set
    entry that was never inserted simply matches nothing. Returns None when
    no filter was requested (the unfiltered fast path stays mask-free)."""
    if allow_ids is None and deny_ids is None:
        return None
    mask = np.ones(n, dtype=bool)
    if allow_ids is not None:
        allow = np.zeros(n, dtype=bool)
        for ext in allow_ids:
            if ext in idmap:
                allow[idmap.lookup(ext)] = True
        mask &= allow
    if deny_ids is not None:
        for ext in deny_ids:
            if ext in idmap:
                mask[idmap.lookup(ext)] = False
    return mask


def filter_mask(
    n: int,
    allow_ids=None,
    deny_ids=None,
    device="cuda",
) -> torch.Tensor:
    """Convenience: dense allow mask from optional allow/deny id lists
    (reference idFilterPass allow/deny modes), on `device` (the card unless
    the caller asks for the CPU)."""
    mask = torch.ones(n, dtype=torch.bool, device=device)
    if allow_ids is not None:
        mask &= bitset_to_mask(bitset_from_ids(allow_ids, n, device=device), n)
    if deny_ids is not None:
        mask &= ~bitset_to_mask(bitset_from_ids(deny_ids, n, device=device), n)
    return mask
