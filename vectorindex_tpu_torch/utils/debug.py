"""Debug-mode checks: non-finite values at the search outputs and the
control plane's invariants.

Counterpart of vectorindex_tpu.utils.debug (parity targets: the reference's
DEBUG-gated assertions, PQLUT.swift:26-33, and its internal-ID drift check,
IVFIndex.swift:168-171).

The JAX module's enable() turns on jax_debug_nans / jax_debug_infs, a trap
on every jitted operation. PyTorch has no such global trap, so here enable()
turns on `check_finite` and one check at the output of the searches: the
distances of FlatIndex, IVFIndex, IVFPQIndex and HNSWIndex `batch_search`,
read on the host after the search's own copy and before the Python results
are built. It traps only there: a NaN or -inf that escapes an operation
inside a search and does not reach its distances is not seen. +inf is the
dead-slot sentinel (ops/topk.INVALID_DIST) and passes. While disabled the
checks return at once and read nothing, so they add no host
synchronisation.

  - enable() / disable() / is_enabled();
  - check_finite(name, arr): raise INTERNAL_INVARIANT on any NaN or inf in
    a numpy array or a torch tensor (copied to the host);
  - check_index_invariants(index): id map ↔ slots ↔ store consistency.
"""

from __future__ import annotations

import numpy as np

from vectorindex_tpu_torch.utils.errors import ErrorBuilder, IndexErrorKind

_enabled = False


def enable() -> None:
    """Check for NaN/Inf at check_finite and at the search outputs (costs a
    host pass over each search's distances: debug runs only)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def _host(arr) -> np.ndarray:
    """numpy view of arr; a torch tensor is copied to the host as f32 or
    wider (numpy has no bf16)."""
    if hasattr(arr, "detach"):
        t = arr.detach()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(arr)


def _raise(name: str, a: np.ndarray, what: str) -> None:
    raise (
        ErrorBuilder(IndexErrorKind.INTERNAL_INVARIANT)
        .message(f"{what} values in {name}")
        .detail("nan", int(np.isnan(a).sum()))
        .detail("inf", int(np.isinf(a).sum()))
        .build()
    )


def check_finite(name: str, arr) -> None:
    if not _enabled:
        return
    a = _host(arr)
    if not np.all(np.isfinite(a)):
        _raise(name, a, "non-finite")


def check_search_output(name: str, dist) -> None:
    """A search's ascending distances: NaN or -inf traps, +inf (an empty
    result slot) does not."""
    if not _enabled:
        return
    a = _host(dist)
    if np.isnan(a).any() or np.isneginf(a).any():
        _raise(name, a, "NaN or -inf")


def check_index_invariants(index) -> None:
    """Control-plane invariant sweep (reference internal-ID drift check,
    IVFIndex.swift:168-171). Raises INTERNAL_INVARIANT on violation."""
    problems: list[str] = []
    idmap = getattr(index, "_idmap", None)
    if idmap is None:
        return
    # every external id maps to a live slot and back
    for ext, slot in idmap.items():
        if idmap.external_for(slot) != ext:
            problems.append(f"idmap asymmetry at {ext!r}->{slot}")
    # family-specific checks
    slot_list = getattr(index, "_slot_list", None)
    if slot_list is not None and getattr(index, "trained", False):
        assigned = set(slot_list.keys())
        mapped = {slot for _, slot in idmap.items()}
        drift = mapped - assigned
        if drift:
            problems.append(f"{len(drift)} mapped slots missing list assignment")
    valid = getattr(index, "_valid", None)
    if valid is not None:
        for ext, slot in idmap.items():
            if not valid[slot]:
                problems.append(f"live id {ext!r} points at tombstoned slot {slot}")
                break
    if problems:
        raise (
            ErrorBuilder(IndexErrorKind.INTERNAL_INVARIANT)
            .message("; ".join(problems[:5]))
            .detail("count", len(problems))
            .build()
        )
