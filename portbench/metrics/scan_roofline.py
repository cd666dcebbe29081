"""scan_roofline: the least time of the window's flat scans over their
`score_flat` spans, in percent.

The least time of a call is the larger of its bytes over the HBM rate and
its operations over the storage dtype's peak (roofline.py), counted once
over the live rows; the span (TELEM's `score_flat`, read through a
recorder) runs from the fused scan's launch to the copy of its `exact`
flags to the host, which waits for K2. Sums over the window: every call
counts, as its share of the time."""

from portbench import roofline


def read(run):
    cfg = run.cfg
    if cfg["index"]["type"] != "flat":
        return None
    least, spans, bound = 0.0, 0.0, None
    for n, stages in zip(run.sizes, run.stage_ms):
        if "score_flat" not in stages:
            continue
        got = roofline.least_seconds(run.kind, int(cfg["rows"]), int(cfg["dimension"]),
                                     cfg["index"]["storage_dtype"], n, run.k)
        if got is None:
            return None
        least += got[0]
        spans += stages["score_flat"] * 1e-3
        bound = got[1]
    if spans <= 0:
        return None
    return 100.0 * least / spans, f"bounded by {bound}: {least * 1e3:.6f} ms of scans at least in {spans * 1e3:.6f} ms of spans"
