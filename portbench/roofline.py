"""Peaks of the chip and the flat scan's least work.

Peaks are NVIDIA's published dense rates for the H100 SXM at its 700 W
limit. The scan's work is counted once, over the live rows: each input
byte read once (rows, their norms, the queries) and each output byte
written once (k ids and distances a query), and 2 B rows d operations.
K1 and K2 each read the corpus, and the kernels scan the whole capacity;
neither is counted, so a design that skips dead slots or fuses the passes
reads as a gain against the same bound, and no reading can pass 100%.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: (device-name key, {"hbm": bytes/s, dtype: operations/s})
PEAKS = (
    ("H100", {"hbm": 3.35e12, "bfloat16": 989e12, "float32": 67e12}),
)

_ITEMSIZE = {"bfloat16": 2, "float32": 4}


def peaks(kind: str) -> Optional[dict]:
    """The table row whose key the device name contains, or None."""
    for key, row in PEAKS:
        if key in kind:
            return row
    return None


def flat_scan_work(rows: int, d: int, dtype: str, batch: int, k: int) -> Tuple[int, int]:
    """(bytes, operations) of one exact top-k scan of `batch` f32 queries
    over `rows` live rows of width d stored in `dtype`."""
    read = rows * d * _ITEMSIZE[dtype] + rows * 4 + batch * d * 4
    written = batch * k * 8
    return read + written, 2 * batch * rows * d


def least_seconds(kind: str, rows: int, d: int, dtype: str, batch: int, k: int) -> Optional[Tuple[float, str]]:
    """(least seconds of one scan, "bytes" or "operations": which bounds
    it), or None where the device has no row in PEAKS."""
    row = peaks(kind)
    if row is None:
        return None
    nbytes, ops = flat_scan_work(rows, d, dtype, batch, k)
    t_bytes, t_ops = nbytes / row["hbm"], ops / row[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
