"""Preflight checks — ASSEMBLER_PREFLIGHT analogue.

The port's own copy of supernova_tpu/pipeline/preflight.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference behavior (mro/stages/preflight/denovo/__init__.py): validate the
sample definition, FASTQ presence/naming, 16bp barcode whitelist, read
length (exit <125 / warn <150), and resource advisories before any heavy
work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List

from ..ingest.barcodes import BC_LEN
from ..ingest.fastq import read_fastq

MIN_READ_LEN_EXIT = 125  # alarms-supernova.json:5-15
MIN_READ_LEN_WARN = 150


@dataclass
class PreflightResult:
    ok: bool
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)


def preflight(
    r1_paths: List[str],
    r2_paths: List[str],
    whitelist_size: int,
    sample_reads: int = 100,
) -> PreflightResult:
    res = PreflightResult(True)
    if len(r1_paths) != len(r2_paths):
        res.errors.append(
            f"{len(r1_paths)} R1 files vs {len(r2_paths)} R2 files"
        )
    if not r1_paths:
        res.errors.append("no input FASTQs")
    for p in [*r1_paths, *r2_paths]:
        if not Path(p).exists():
            res.errors.append(f"missing FASTQ: {p}")
    if whitelist_size < 2:
        res.errors.append("barcode whitelist is empty or degenerate")

    if not res.errors:
        # sample read lengths from the first R2 (genomic read)
        lens = []
        try:
            for i, (_, codes, _) in enumerate(read_fastq(r2_paths[0])):
                lens.append(len(codes))
                if i + 1 >= sample_reads:
                    break
        except Exception as e:  # malformed file
            res.errors.append(f"cannot parse {r2_paths[0]}: {e}")
        if lens:
            mean_len = sum(lens) / len(lens)
            if mean_len < MIN_READ_LEN_EXIT:
                res.errors.append(
                    f"mean read length {mean_len:.0f} < {MIN_READ_LEN_EXIT};"
                    " assembly unsupported"
                )
            elif mean_len < MIN_READ_LEN_WARN:
                res.warnings.append(
                    f"mean read length {mean_len:.0f} < {MIN_READ_LEN_WARN};"
                    " results may be degraded"
                )
        # R1 must carry barcode + trim + sequence
        for _, codes, _ in read_fastq(r1_paths[0]):
            if len(codes) < BC_LEN + 8:
                res.errors.append("R1 too short to carry a 16bp barcode")
            break

    res.ok = not res.errors
    return res
