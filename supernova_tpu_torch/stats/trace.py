"""Stage timer: wall time, peak device memory and peak host memory per
stage (port of supernova_tpu/stats/trace.py's `stage`).

On a CUDA device the stage ends with torch.cuda.synchronize(), so the wall
time covers the device work it queued, and the device peak is
torch.cuda.max_memory_allocated() since the stage began (allocator bytes,
not the whole process's footprint).  The host peak is the process's VmRSS
high-water mark over the stage, sampled on a daemon thread as the
reference's HighWaterSampler samples it (its device half is left out: the
allocator keeps the exact peak).  They go into the StatLogger as
etime_<stage>_h, mem_peak_<stage>_gb (CUDA only) and
mem_peak_host_<stage>_gb, the reference's schema.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager

import torch

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
