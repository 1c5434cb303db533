"""Stage timer, and spans and counters for torch.profiler.

`stage`: wall time, peak device memory and peak host memory per stage
(port of supernova_tpu/stats/trace.py's `stage`).

On a CUDA device the stage ends with torch.cuda.synchronize(), so the wall
time covers the device work it queued, and the device peak is
torch.cuda.max_memory_allocated() since the stage began (allocator bytes,
not the whole process's footprint).  The host peak is the process's VmRSS
high-water mark over the stage, sampled on a daemon thread as the
reference's HighWaterSampler samples it (its device half is left out: the
allocator keeps the exact peak).  They go into the StatLogger as
etime_<stage>_h, mem_peak_<stage>_gb (CUDA only) and
mem_peak_host_<stage>_gb, the reference's schema.

`span(name, device)`: one step of a call (count_readset's prep, sort,
reduce, recompute; path_readset's prep, join, place), on the profiler's
clock.  With no profiler session running a span is one flag check: no
record_function, no CUDA event, no allocation, no sync.  While one runs,
a span opens a `torch.profiler.record_function(name)`, records a CUDA
event on the device's current stream at entry and at exit (on a card;
read lazily, so the span's device interval, from its first to its last
operation on the stream, costs no sync), and appends to the span log its
name, its parent, its host start and end and the deltas of the counters:
`h2d_bytes` (bytes the program's uploads handed to a device, `upload`),
`sort_rows` and `dead_sort_rows` (the count's occurrence rows that K4
sorts, and those of them holding the sentinel), `join_rows` and
`dead_join_rows` (the pather's query rows, and those that cannot hold a
read's kmer), both pairs added by `count_rows` from shapes and host
arrays while a profiler runs, and each kernel wrapper's `launches` and
`bytes` (ops/kernels).
`spans()` returns the log with device seconds resolved; `clear_spans()`
empties it.  Every program span is named under `call.`: the profiler
also leaves each record_function on the device's timeline, and the
benchmark's trace reader counts such annotations as no work only under
that prefix.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from ..ops import kernels

log = logging.getLogger("supernova_tpu_torch")


def _host_rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except Exception:
        pass
    return 0


class HighWaterSampler:
    """Samples the host RSS on a daemon thread; keeps the max."""

    def __init__(self, period_s: float = 1.0):
        self.period_s = period_s
        self.peak_host = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _sample(self):
        self.peak_host = max(self.peak_host, _host_rss_bytes())

    def _run(self):
        while not self._stop.wait(self.period_s):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._sample()
        return False


@contextmanager
def stage(name: str, device: torch.device, stats, record: dict):
    """Time the enclosed stage, log it into the StatLogger `stats`, and
    store {"wall_s", "peak_gb", "host_peak_gb"} in `record` (peak_gb is
    None off CUDA)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    log.info("STAGE %s: begin", name)
    with HighWaterSampler() as hw:
        yield
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    host = hw.peak_host / 2**30
    log.info("STAGE %s: done in %.3fs (peak device memory %s GiB, host RSS %.2f GiB)",
             name, dt, peak, host)
    stats.log(f"etime_{name}_h", dt / 3600.0, stage=name)
    if peak is not None:
        stats.log(f"mem_peak_{name}_gb", round(peak, 3), stage=name)
    if host:
        stats.log(f"mem_peak_host_{name}_gb", round(host, 3), stage=name)
    record.update(wall_s=dt, peak_gb=peak, host_peak_gb=host)


# ------------------------------------------------------------------ spans

COUNTERS = {
    "h2d_bytes": 0,  # bytes `upload` has handed to a device
    "sort_rows": 0, "dead_sort_rows": 0,  # count_rows("sort", ...): the count's K4 rows
    "join_rows": 0, "dead_join_rows": 0,  # count_rows("join", ...): the pather's queries
}
_OFF = nullcontext()
_LOG: list = []  # [_Span] closed while a profiler ran, in closing order
_OPEN: list = []  # names of the open spans, innermost last


def upload(a: np.ndarray, device) -> torch.Tensor:
    """torch.from_numpy(a).to(device), its bytes counted as h2d_bytes."""
    COUNTERS["h2d_bytes"] += a.nbytes
    return torch.from_numpy(a).to(device)


def tracing() -> bool:
    """Whether a torch.profiler session runs: the one flag a span checks."""
    return torch._C._autograd._profiler_enabled()


def count_rows(kind: str, rows_and_live) -> None:
    """While a profiler runs, rows_and_live() -> (rows, live): add rows to
    the counter `<kind>_rows` and rows - live to `dead_<kind>_rows`; else
    one flag check (rows_and_live is not called)."""
    if tracing():
        rows, live = rows_and_live()
        COUNTERS[f"{kind}_rows"] += int(rows)
        COUNTERS[f"dead_{kind}_rows"] += int(rows) - int(live)


def _counters() -> dict:
    return {**COUNTERS, **kernels.counters()}


class _Span:
    """A span while a profiler runs (span() returns it)."""

    def __init__(self, name: str, device):
        self.name = name
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None and torch.device(device).type == "cuda" else None)
        self.events = ()

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.parent = _OPEN[-1] if _OPEN else None
        _OPEN.append(self.name)
        self.c0 = _counters()
        self.t0 = time.perf_counter()
        if self.stream is not None:
            self.events = (self._event(),)
        return self

    def __exit__(self, *exc):
        if self.stream is not None:
            self.events += (self._event(),)
        self.t1 = time.perf_counter()
        self.c1 = _counters()
        _OPEN.pop()
        _LOG.append(self)
        return self.rf.__exit__(*exc)

    def record(self) -> dict:
        """The span's log entry: device seconds (None off a card) from its
        events, which waits for the exit event where it has not completed."""
        dev_s = None
        if len(self.events) == 2:
            self.events[1].synchronize()
            dev_s = self.events[0].elapsed_time(self.events[1]) / 1e3
        c0, c1 = kernels.resolved(self.c0), kernels.resolved(self.c1)
        return {"name": self.name, "parent": self.parent, "host_start": self.t0,
                "host_end": self.t1, "device_s": dev_s,
                **{k: c1[k] - c0[k] for k in c1}}


def span(name: str, device=None):
    """A context manager marking one step under `name` (a `call.` name):
    while a torch.profiler session runs, a record_function, the step's
    device interval on `device` (a CUDA device; None or a CPU device
    records none) and an entry in the span log; else a shared no-op."""
    if not tracing():
        return _OFF
    return _Span(name, device)


def spans() -> list:
    """The span log, oldest closed first: one dict a span with name,
    parent (the enclosing span's name or None), host_start and host_end
    (time.perf_counter()), device_s (the device interval in seconds, None
    off a card) and the counter deltas (COUNTERS' keys, <kernel>.launches,
    <kernel>.bytes)."""
    return [s.record() for s in _LOG]


def clear_spans() -> None:
    _LOG.clear()
