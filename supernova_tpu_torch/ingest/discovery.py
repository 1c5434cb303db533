"""Input FASTQ discovery — the tenkit find_input_fastqs analogue.

The port's own copy of supernova_tpu/ingest/discovery.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference behavior (tenkit/lib/python/tenkit/fasta.py:155-258): a fastqs
directory holds either
  * ILMN_BCL2FASTQ files `<sample>_S*_L<lane>_R1_001.fastq(.gz)` (directly
    or one subdirectory down, the sample-sheet Project/Sample layout), with
    the mate found by R1 -> R2 substitution, or
  * BCL_PROCESSOR files `read-RA_si-<SI>_lane-<L>*.fastq(.gz)` — RA =
    interleaved R1/R2 records, sample-index in the name (<= 2 Ns allowed
    when filtering by an explicit sample index).
`detect_mode` mirrors find_input_file_type_with_samples.
"""
from __future__ import annotations

import glob
import os
import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

BCL2FASTQ = "ILMN_BCL2FASTQ"
BCL_PROCESSOR = "BCL_PROCESSOR"


def find_bcl2fastq(
    path: str | Path,
    read_type: str = "R1",
    sample: Optional[str] = None,
    lanes: Optional[Sequence[int]] = None,
) -> List[str]:
    """bcl2fastq-demultiplexed files (fasta.py:193-227)."""
    sample = sample or "*"
    pats = []
    if lanes:
        for lane in lanes:
            pats.append(
                f"{sample}_*_L{int(lane):03d}_{read_type}_[0-9][0-9][0-9].fastq*"
            )
    else:
        pats.append(f"{sample}_*_L[0-9][0-9][0-9]_{read_type}_[0-9][0-9][0-9].fastq*")
    files: List[str] = []
    for pat in pats:
        got = glob.glob(os.path.join(str(path), "*", pat))  # Project/Sample
        if not got:
            got = glob.glob(os.path.join(str(path), pat))
        files.extend(got)
    return sorted(files)


def find_bcl_processor(
    path: str | Path,
    read_type: str = "RA",
    sample_index: str = "*",
    lanes: Optional[Sequence[int]] = None,
    max_ns: int = 2,
) -> List[str]:
    """BCL_PROCESSOR (demux) files (fasta.py:155-190)."""
    if sample_index != "*":
        si_glob = "".join(f"[{b}N]" for b in sample_index)
    else:
        si_glob = "*"
        max_ns = 100
    if lanes:
        files: List[str] = []
        for lane in lanes:
            files.extend(
                glob.glob(
                    os.path.join(
                        str(path),
                        f"read-{read_type}_si-{si_glob}_lane-{int(lane):03d}*.fastq*",
                    )
                )
            )
    else:
        files = glob.glob(
            os.path.join(str(path), f"read-{read_type}_si-{si_glob}_*.fastq*")
        )
    good = []
    for f in files:
        m = re.match(r".*si-([A-ZN]*)_", os.path.basename(f))
        if m and m.group(1).count("N") > max_ns:
            continue
        good.append(f)
    return sorted(good)


def detect_mode(path: str | Path) -> Tuple[Optional[str], List[str]]:
    """-> (mode, sample prefixes) (find_input_file_type_with_samples)."""
    if find_bcl_processor(path):
        return BCL_PROCESSOR, []
    r1s = find_bcl2fastq(path, "R1")
    if not r1s:
        return None, []
    samples = sorted(
        {re.sub(r"_S\d+_L\d{3}_R1_\d{3}\.fastq.*$", "", os.path.basename(f))
         for f in r1s}
    )
    return BCL2FASTQ, samples


def discover_input_fastqs(
    path: str | Path,
    sample: Optional[str] = None,
    lanes: Optional[Sequence[int]] = None,
) -> dict:
    """-> {"mode", "r1", "r2", "interleaved"} ready for ingest_10x_fastqs.

    Raises ValueError with the detected sample list when `sample` is needed
    to disambiguate (the reference's AmbiguousValueError)."""
    mode, samples = detect_mode(path)
    if mode == BCL_PROCESSOR:
        ra = find_bcl_processor(path, "RA", sample or "*", lanes)
        return {"mode": mode, "r1": ra, "r2": [], "interleaved": True}
    if mode == BCL2FASTQ:
        if sample is None and len(samples) > 1:
            raise ValueError(
                f"multiple samples in {path}: {samples}; pass --sample"
            )
        r1 = find_bcl2fastq(path, "R1", sample, lanes)
        r2 = []
        for f in r1:
            mate = f.replace("_R1_", "_R2_")
            if not os.path.exists(mate):
                raise FileNotFoundError(f"missing mate for {f}")
            r2.append(mate)
        return {"mode": mode, "r1": r1, "r2": r2, "interleaved": False}
    raise ValueError(f"no 10x FASTQs found under {path}")
