"""Stage timer: wall time and peak device memory per stage (port of
supernova_tpu/stats/trace.py's `stage`).

On a CUDA device the stage ends with torch.cuda.synchronize(), so the wall
time covers the device work it queued, and the peak is
torch.cuda.max_memory_allocated() since the stage began (allocator bytes,
not the whole process's footprint).  On the CPU only the wall time is
recorded.  Both go into the StatLogger as etime_<stage>_h and
mem_peak_<stage>_gb, the reference's schema.
"""
from __future__ import annotations

import logging
import time
from contextlib import contextmanager

import torch

log = logging.getLogger("supernova_tpu_torch")


@contextmanager
def stage(name: str, device: torch.device, stats, record: dict):
    """Time the enclosed stage, log it into the StatLogger `stats`, and
    store {"wall_s": ..., "peak_gb": ...} in `record` (peak is None off
    CUDA)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    log.info("STAGE %s: begin", name)
    yield
    if cuda:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    log.info("STAGE %s: done in %.3fs (peak device memory %s GiB)", name, dt, peak)
    stats.log(f"etime_{name}_h", dt / 3600.0, stage=name)
    if peak is not None:
        stats.log(f"mem_peak_{name}_gb", round(peak, 3), stage=name)
    record.update(wall_s=dt, peak_gb=peak)
