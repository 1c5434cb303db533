"""Sample-index demultiplexing — the BCL_PROCESSOR demux stage.

The port's own copy of supernova_tpu/ingest/demux.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of tenkit/mro/stages/bcl_processor/demultiplex/__init__.py:
auto-discover the common sample indexes from a sample of the SI reads
(the 75%-cumulative-mass rule with a min-observation floor,
`pick_common_indexes`, :152-183), then route every read set to
`read-<TYPE>_si-<SEQ>_lane-...fastq.gz` files (exact SI match; invalid
indexes to si-X, :190-231), plus a per-index count summary.

The upstream raw-BCL decode (barcode_aware_bcl2fastq) needs an Illumina
run folder + basecaller and is gated in cli.mkfastq with an actionable
error; everything downstream of basecalled FASTQs is implemented here.
"""
from __future__ import annotations

import gzip
import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

MAX_INDICES = 1000  # demultiplex/__init__.py:60
INVALID_SAMPLE_INDEX = "X"  # :61


def _open(path):
    p = str(path)
    return gzip.open(p, "rt") if p.endswith(".gz") else open(p)


def iter_fastq(path):
    """-> (header, seq, qual) triples."""
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            s = f.readline().strip()
            f.readline()
            q = f.readline().strip()
            yield h.strip(), s, q


def get_index_counts(si_fastqs: Sequence[str], sample_size: int = 1_000_000):
    """Sample SI reads -> sequence counts (:136-149)."""
    counts: Counter = Counter()
    for fq in si_fastqs:
        n = 0
        for _, seq, _ in iter_fastq(fq):
            counts[seq] += 1
            n += 1
            if n > sample_size:
                break
    return counts


def pick_common_indexes(si_fastqs: Sequence[str]) -> Tuple[List[str], List[str]]:
    """(good, noise) sample indexes: the indexes covering 75% of reads
    set the median-count scale; keep those above max(median/200, 25),
    capped at MAX_INDICES (:152-183)."""
    counts = get_index_counts(si_fastqs)
    items = sorted(counts.items(), key=lambda kv: kv[1], reverse=True)
    total = sum(v for _, v in items)
    c = 0
    c75 = 0
    for i, (_, v) in enumerate(items):
        c += v
        c75 = i
        if c > 0.75 * total:
            break
    med = float(np.median([v for _, v in items[: c75 + 1]])) if items else 0
    min_obs = max(med / 200, 25)
    if len(items) > MAX_INDICES:
        min_obs = max(min_obs, items[MAX_INDICES][1])
    good = [k for k, v in items if v > min_obs]
    noise = [k for k, v in items if v <= min_obs]
    return good, noise


def demultiplex(
    si_fastq: str,
    read_fastqs: Dict[str, str],
    out_dir: str | Path,
    indexes: Sequence[str] | None = None,
    lane: int = 1,
    max_reads: int = -1,
) -> Dict[str, int]:
    """Route read sets by exact SI match (process_fastq_chunk, :190-231).

    read_fastqs maps read type (RA/R1/R2/I1...) -> fastq path, all
    record-parallel with si_fastq.  indexes=None auto-discovers via
    pick_common_indexes.  Returns per-index read-set counts (invalid
    under 'X')."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if indexes is None:
        indexes, _ = pick_common_indexes([si_fastq])
    valid = set(indexes)

    streams: Dict[Tuple[str, str], object] = {}

    def stream(si: str, rt: str):
        key = (si, rt)
        if key not in streams:
            name = f"read-{rt}_si-{si}_lane-{lane:03d}-chunk-001.fastq.gz"
            streams[key] = gzip.open(out_dir / name, "wt")
        return streams[key]

    counts: Counter = Counter()
    iters = [iter_fastq(si_fastq)] + [iter_fastq(p) for p in read_fastqs.values()]
    types = list(read_fastqs.keys())
    n = 0
    for recs in zip(*iters):
        si_seq = recs[0][1]
        si = si_seq if si_seq in valid else INVALID_SAMPLE_INDEX
        counts[si] += 1
        for rt, (h, s, q) in zip(types, recs[1:]):
            w = stream(si, rt)
            w.write(f"{h}\n{s}\n+\n{q}\n")
        n += 1
        if 0 < max_reads <= n:
            break
    for w in streams.values():
        w.close()
    summary = dict(sorted(counts.items()))
    with open(out_dir / "demultiplex_summary.json", "w") as f:
        json.dump(summary, f, indent=1)
    return summary
