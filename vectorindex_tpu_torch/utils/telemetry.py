"""Telemetry: per-query stats, stage timers, histograms, ring buffer, JSON
snapshot.

Parity target (reference kernel #46): Kernels/Telemetry.swift —
  - compile-time gate -D VINDEX_TELEM with no-op API otherwise (:8-10, :244)
    → here a runtime `enabled` flag; the disabled path is a cheap no-op
  - per-query stage timers (TelemetryTimerId :31-41: lut_build, scan_adc,
    score_flat, topk, merge, dedup, reservoir, rerank, total)
  - work counters (lists routed/scanned, codes scanned, candidates
    emitted/unique/kept — QueryStats :55-104)
  - byte counters per stream (lut/codes/vecs/ids/norms :215)
  - code-path flags (dot-trick, cosine, interleaved, u4, … :44-52)
  - lock-striped histograms, sampling rate, 1024-entry recent-query ring
    buffer, JSON snapshot export (telem_snapshot_json :197)
  - RAII TelemetryTimerGuard (:226-233) → context manager here
  - per-kernel TelemetryRecorder sink callbacks (e.g. L2SqrKernel.swift:55)

Stages are additionally wrapped in torch.profiler.record_function ranges so
the counters line up with torch.profiler timelines (host and CUDA kernels).

Device spans: inside a call record (`call(stats)`), `device_span(name, t)`
brackets work on a CUDA tensor's current stream with two CUDA events from a
small reused pool; the record's close reads their elapsed time into
`stats.stage_ms["dev.<name>"]` (ms). It closes after the call's copies to
the host, which wait for the stream, so reading adds no synchronisation.
Disabled, a timer, a call record and a device span are each one flag test
and the shared null context: no event is made or recorded.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.profiler import record_function

#: what a disabled timer, call record or device span returns
_NULL = nullcontext()

# stage names mirroring TelemetryTimerId (Telemetry.swift:31-41)
STAGES = (
    "lut_build",
    "scan_adc",
    "score_flat",
    "select",
    "topk",
    "merge",
    "dedup",
    "reservoir",
    "rerank",
    "traversal",
    "total",
)

# byte-stream names (Telemetry.swift:215)
STREAMS = ("lut", "codes", "vecs", "ids", "norms")


@dataclass
class QueryStats:
    """One query(-batch)'s record (reference QueryStats, Telemetry.swift:55-104)."""

    ts: float = 0.0
    batch: int = 1
    stage_ms: dict = field(default_factory=dict)
    lists_routed: int = 0
    lists_scanned: int = 0
    codes_scanned: int = 0
    rows_scored: int = 0
    candidates_emitted: int = 0
    candidates_unique: int = 0
    candidates_kept: int = 0
    bytes_read: dict = field(default_factory=dict)
    flags: set = field(default_factory=set)  # dot_trick / cosine / u4 / …


class _Histogram:
    """Power-of-two bucketed latency histogram (the lock-striping of the
    reference collapses to one lock — Python's GIL makes striping moot)."""

    BUCKETS = 32

    def __init__(self):
        self.counts = [0] * self.BUCKETS

    def record(self, value_us: float) -> None:
        b = min(max(int(value_us).bit_length(), 0), self.BUCKETS - 1)
        self.counts[b] += 1

    def snapshot(self) -> dict:
        return {
            f"<{1 << b}us": c for b, c in enumerate(self.counts) if c
        }


class Telemetry:
    """Process-wide telemetry sink (reference's pthread-TLS state collapses
    to one lock-guarded aggregate)."""

    RING_SIZE = 1024  # reference recent-query ring buffer size

    def __init__(self, enabled: bool = False, sample_rate: float = 1.0):
        self.enabled = enabled
        self.sample_rate = sample_rate
        self._lock = threading.Lock()
        self._counters: dict[str, int] = defaultdict(int)
        self._bytes: dict[str, int] = defaultdict(int)
        self._stage_hist: dict[str, _Histogram] = defaultdict(_Histogram)
        self._ring: deque[QueryStats] = deque(maxlen=self.RING_SIZE)
        self._recorders: dict[str, Callable[[QueryStats], None]] = {}
        self._seq = 0
        # the open call record of each thread (its device spans as (name,
        # device, start, end)), and idle timing events by device
        self._tls = threading.local()
        self._events: dict[torch.device, list] = defaultdict(list)

    # -- gating --

    def enable(self, sample_rate: float = 1.0) -> None:
        self.enabled = True
        self.sample_rate = sample_rate

    def disable(self) -> None:
        self.enabled = False

    def _sampled(self) -> bool:
        if not self.enabled:
            return False
        if self.sample_rate >= 1.0:
            return True
        self._seq += 1
        return (self._seq * 2654435761 % (1 << 32)) / (1 << 32) < self.sample_rate

    # -- counters (reference TELEM_INC / ADD_BYTES macros) --

    def inc(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] += n

    def add_bytes(self, stream: str, n: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._bytes[stream] += n

    # -- timers (reference TelemetryTimerGuard) --

    def timer(self, stage: str, stats: Optional[QueryStats] = None):
        """Stage timer + torch.profiler range. No-op when disabled."""
        if not self.enabled:
            return _NULL
        return self._timed(stage, stats)

    @contextmanager
    def _timed(self, stage: str, stats: Optional[QueryStats]):
        t0 = time.perf_counter()
        with record_function(f"vindex.{stage}"):
            yield
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._stage_hist[stage].record(ms * 1e3)
            self._counters[f"time_ms.{stage}"] += ms
        if stats is not None:
            stats.stage_ms[stage] = stats.stage_ms.get(stage, 0.0) + ms

    # -- device spans (CUDA events) --

    def call(self, stats: QueryStats):
        """Open `stats` as this thread's call record for device spans; on a
        clean close their times are added to stats.stage_ms. Close it only
        after the call has waited for the stream its spans ran on (a copy
        to the host does)."""
        if not self.enabled:
            return _NULL
        return self._call(stats)

    @contextmanager
    def _call(self, stats: QueryStats):
        outer = getattr(self._tls, "spans", None)
        spans = self._tls.spans = []
        try:
            yield
            for name, _, start, end in spans:
                if end.query():  # complete: elapsed_time does not wait
                    key = f"dev.{name}"
                    stats.stage_ms[key] = stats.stage_ms.get(key, 0.0) + start.elapsed_time(end)
        finally:
            self._tls.spans = outer
            with self._lock:
                for _, device, start, end in spans:
                    self._events[device].extend((start, end))

    def device_span(self, name: str, t):
        """Time the device work issued in the block on the current stream of
        tensor t's device, as dev.<name> of the open call record. No-op when
        disabled, with no call record open, or off CUDA."""
        if not self.enabled:
            return _NULL
        spans = getattr(self._tls, "spans", None)
        if spans is None or t.device.type != "cuda":
            return _NULL
        return self._device_timed(name, t.device, spans)

    @contextmanager
    def _device_timed(self, name: str, device: torch.device, spans: list):
        with self._lock:
            pool = self._events[device]  # events come and go in pairs
            start, end = (pool.pop(), pool.pop()) if pool else (
                torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        stream = torch.cuda.current_stream(device)
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            spans.append((name, device, start, end))

    # -- per-query records --

    def record_query(self, stats: QueryStats) -> None:
        if not self._sampled():
            return
        stats.ts = time.time()
        with self._lock:
            self._ring.append(stats)
            self._counters["queries"] += stats.batch
        for cb in self._recorders.values():
            cb(stats)

    def record_kernel(
        self, name: str, *, calls: int = 1, rows: int = 0, bytes: int = 0
    ) -> None:
        """Per-KERNEL counter sink (reference per-kernel static
        TelemetryRecorder callbacks — L2SqrKernel.swift:46-57,
        TopK.swift:46, HNSWTraversal.swift:12-23). The counters bump at
        the host call sites in models/, naming the kernel that ran; snapshot()
        surfaces them as kernel.<name>.{calls,rows,bytes} so kernel-level
        benches report per-op counters like the reference's
        L2SqrMicrobench."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[f"kernel.{name}.calls"] += calls
            if rows:
                self._counters[f"kernel.{name}.rows"] += rows
            if bytes:
                self._counters[f"kernel.{name}.bytes"] += bytes

    def register_recorder(self, name: str, cb: Callable[[QueryStats], None]) -> None:
        """Per-kernel sink callback (reference static TelemetryRecorder)."""
        self._recorders[name] = cb

    def unregister_recorder(self, name: str) -> None:
        self._recorders.pop(name, None)

    # -- export (reference telem_snapshot_json, Telemetry.swift:197) --

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "bytes": dict(self._bytes),
                "stage_histograms_us": {
                    k: h.snapshot() for k, h in self._stage_hist.items()
                },
                "recent_queries": len(self._ring),
            }

    def snapshot_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.snapshot(), sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    def recent(self, n: int = 16) -> list[QueryStats]:
        with self._lock:
            return list(self._ring)[-n:]

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._bytes.clear()
            self._stage_hist.clear()
            self._ring.clear()


#: process-wide instance; disabled by default (the VINDEX_TELEM analog)
TELEM = Telemetry(enabled=False)


def enable(sample_rate: float = 1.0) -> None:
    TELEM.enable(sample_rate)


def disable() -> None:
    TELEM.disable()
