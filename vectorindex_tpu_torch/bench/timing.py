"""Device timing helpers of the port's benchmark.

On the card a search is timed by CUDA events around m calls over distinct
[b, d] slices of a query pool, each call's outputs added into one running
sum on the device, so no call is dead and the host's clock never measures
the enqueue alone. On the CPU, where every operator runs before it
returns, the host clock does the same. A CUDA device with no card visible
raises (`resolve_device`): nothing falls back to the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device of `device`; a CUDA device raises when no card is
    visible (pass device="cpu" to run on the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs an NVIDIA GPU and none is visible; "
            "pass device='cpu' (--device cpu) to run on the host"
        )
    return dev


def _loop(search_outputs_fn, qpool: torch.Tensor, b: int, m: int, args):
    """Sum of search_outputs_fn's outputs over the first m [b, d] slices."""
    acc = None
    for i in range(m):
        o = search_outputs_fn(qpool[i * b : (i + 1) * b], *args)
        acc = tuple(o) if acc is None else tuple(a + x for a, x in zip(acc, o))
    return acc


def time_loop(search_outputs_fn, qpool, b: int, m: int, repeats: int = 3,
              args=(), return_samples: bool = False, device="cuda"):
    """(seconds_per_batch, outputs): m calls of search_outputs_fn(q, *args)
    over the distinct slices q = qpool[i·b : (i+1)·b], i < m, timed by CUDA
    events on the card (the host clock on the CPU), after one warm call.
    search_outputs_fn returns a tuple of scalar tensors (float first, then
    integers); `outputs` are their sums over the m calls of the last
    repeat, as numpy scalars.

    The estimator is the MEDIAN of the repeats' times per batch; callers
    that need a physical-sanity floor pass return_samples=True and apply
    their own roofline check over the raw samples.

    qpool (numpy or a tensor) moves to `device`; pass corpus-sized tensors
    through `args` on that device."""
    dev = resolve_device(device)
    qpool = torch.as_tensor(qpool, device=dev)
    if qpool.shape[0] < m * b:
        raise ValueError(f"qpool has {qpool.shape[0]} rows; {m} slices of {b} need {m * b}")
    _loop(search_outputs_fn, qpool, b, 1, args)  # warm (first launches, builds)
    samples = []
    r = None
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = _loop(search_outputs_fn, qpool, b, m, args)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / m)
        else:
            t0 = time.perf_counter()
            r = _loop(search_outputs_fn, qpool, b, m, args)
            samples.append((time.perf_counter() - t0) / m)
    est = _median(samples)
    out = tuple(np.asarray(t.cpu()) for t in r)
    if return_samples:
        return est, out, samples
    return est, out


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def time_host(fn, repeats: int = 3, device="cuda"):
    """Best-of-N wall-clock for host-side paths (e.g. index.batch_search
    including result assembly). fn must consume its own outputs; on the
    card the clock stops after the device has finished."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()  # warm (first launches, builds)
    sync()
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best = dt
    return best
