"""scan_kernel_roofline: the least time of the window's flat scans over the
time K1 and K2 took on the device, in percent.

The least time of a call is scan_roofline's (roofline.py, a call at its own
size); the kernels' time is TELEM's `dev.k1` + `dev.k2`, CUDA events around
each launch. Sums over the window's calls with both spans. Kernel time is at
most the `score_flat` span, so this reads at or above scan_roofline."""

from portbench import roofline


def read(run):
    cfg = run.cfg
    if cfg["index"]["type"] != "flat":
        return None
    least, kernels, bound = 0.0, 0.0, None
    for n, stages in zip(run.sizes, run.stage_ms):
        if "dev.k1" not in stages or "dev.k2" not in stages:
            continue
        got = roofline.least_seconds(run.kind, int(cfg["rows"]), int(cfg["dimension"]),
                                     cfg["index"]["storage_dtype"], n, run.k)
        if got is None:
            return None
        least += got[0]
        kernels += (stages["dev.k1"] + stages["dev.k2"]) * 1e-3
        bound = got[1]
    if kernels <= 0:
        return None
    return 100.0 * least / kernels, f"bounded by {bound}: {least * 1e3:.6f} ms of scans at least in {kernels * 1e3:.6f} ms of K1 and K2"
