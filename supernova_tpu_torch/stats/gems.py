"""GEM-count / loading-mass / memory preflight estimators.

The port's own copy of supernova_tpu/stats/gems.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogues of EstimateGEMCount (10X/DfTools.cc:550-594) and of the two
closed-source preflight metrics whose alarm envelopes ship in
tenkit/lib/python/tenkit/alarms/alarms-supernova.json:17-36
(`mem_per_read`, `loading_mass`).  The producers for those two are not
in the public tree, so the formulas here are documented first-principles
estimates wired to the reference thresholds.
"""
from __future__ import annotations

import math

import numpy as np

# dsDNA mass: ~650 g/mol per base pair / Avogadro, expressed in ng
DNA_NG_PER_BP = 650.0 / 6.022e23 * 1e9

# alarms-supernova.json:17-22 — MB of RAM per input read below which the
# run is at OOM risk (256 GB for a 1200M-read human dataset envelope)
MEM_PER_READ_MB_MIN = 0.0001066

LOADING_MASS_NG_MIN = 0.6  # alarms-supernova.json:24-29
LOADING_MASS_NG_MAX = 2.5  # alarms-supernova.json:31-36


def estimate_gem_count(bci, total_diversity: int = 0) -> int:
    """Occupancy-based GEM count (EstimateGEMCount, DfTools.cc:550-594):
    barcodes above the N99-cumulative / >=4-reads gate are 'occupied';
    Poisson occupancy of the whitelist then gives the mean GEMs per
    barcode (-log(1-p)) and the total GEM count.  total_diversity is the
    whitelist size; 0 disables the estimate (returns 0), as does full
    occupancy.  (The reference counts each barcode's reads with an extra
    +1, DfTools.cc:560; the true count is used here.)"""
    if total_diversity <= 0:
        return 0
    bci = np.asarray(bci, np.int64)
    if len(bci) < 3:
        return 0
    rpb = np.sort(np.diff(bci)[1:])  # per real barcode (0 = unbarcoded)
    nreads = int(rpb.sum())
    if nreads == 0:
        return 0
    cum = np.cumsum(rpb)
    ok = (cum >= (1 - 0.99) * nreads) & (rpb >= 4)
    if not ok.any():
        return 0
    bcs = int(len(rpb) - np.argmax(ok))
    if bcs == 0 or bcs >= total_diversity:
        return 0
    p_occupied = bcs / total_diversity
    mean_gems_per_bc = -math.log(1.0 - p_occupied)
    return int(mean_gems_per_bc * total_diversity)


def estimate_loading_mass_ng(molecules) -> float | None:
    """Loading mass (ng) estimate: total inferred input-molecule bases
    times the dsDNA mass per base pair.  Inferred molecule spans slightly
    underestimate true molecule length (they span the observed reads), so
    this is a lower-bound style estimate; the reference's 0.6-2.5 ng
    envelope (alarms-supernova.json:24-36) applies."""
    if not molecules:
        return None
    total_bp = sum(int(m.length) for m in molecules)
    if total_bp <= 0:
        return None
    return total_bp * DNA_NG_PER_BP


def mem_per_read_mb(n_reads: int) -> float | None:
    """MB of available system memory per input read — the reference's
    'conservative estimate of memory usage per input read, serves as
    precursor to OOM killers' (alarms-supernova.json:17-22)."""
    if n_reads <= 0:
        return None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    kb = int(line.split()[1])
                    return kb / 1024.0 / n_reads
    except (OSError, ValueError, IndexError):
        return None
    return None
