"""FASTQ / FASTH file IO (host side).

The port's own copy of supernova_tpu/ingest/fastq.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

FASTH is the reference's barcode-sorted interchange format: 8-line records
r1, q1, r2, q2, bc, bcq, si, siq (10X/ParseBarcodedFastqs.cc:3-6).  Quals are
ASCII phred+33.  A C++ fast path for decode/2-bit-pack plugs in underneath
(see supernova_tpu/ops/native); this module is the portable fallback and the
format authority.
"""
from __future__ import annotations

import gzip
import io
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from ..core import dna

QUAL_OFFSET = 33


def _open(path: str | Path, mode: str):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def qual_str_to_phred(q: str) -> np.ndarray:
    return np.frombuffer(q.encode(), dtype=np.uint8) - QUAL_OFFSET


def phred_to_qual_str(q: np.ndarray) -> str:
    return (np.asarray(q, dtype=np.uint8) + QUAL_OFFSET).tobytes().decode()


def read_fastq(path: str | Path) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """Yield (name, codes, quals) per record."""
    with _open(path, "rt") as f:
        while True:
            name = f.readline()
            if not name:
                return
            seq = f.readline().strip()
            f.readline()  # '+'
            qual = f.readline().strip()
            yield name.strip()[1:], dna.seq_to_codes(seq), qual_str_to_phred(qual)


def write_fastq(path: str | Path, records) -> None:
    with _open(path, "wt") as f:
        for name, codes, quals in records:
            f.write(f"@{name}\n{dna.codes_to_seq(codes)}\n+\n{phred_to_qual_str(quals)}\n")


def write_fasth(path: str | Path, records) -> None:
    """records: iterable of dicts with r1,q1,r2,q2,bc,bcq,si,siq arrays
    (si/siq may be empty)."""
    with _open(path, "wt") as f:
        for r in records:
            for key in ("r1", "r2", "bc", "si"):
                qkey = {"r1": "q1", "r2": "q2", "bc": "bcq", "si": "siq"}[key]
                f.write(dna.codes_to_seq(r[key]) + "\n")
                f.write(phred_to_qual_str(r[qkey]) + "\n")


def read_fasth(path: str | Path) -> Iterator[dict]:
    with _open(path, "rt") as f:
        while True:
            lines = [f.readline() for _ in range(8)]
            if not lines[0]:
                return
            r1, q1, r2, q2, bc, bcq, si, siq = (l.rstrip("\n") for l in lines)
            yield dict(
                r1=dna.seq_to_codes(r1),
                q1=qual_str_to_phred(q1),
                r2=dna.seq_to_codes(r2),
                q2=qual_str_to_phred(q2),
                bc=dna.seq_to_codes(bc),
                bcq=qual_str_to_phred(bcq),
                si=dna.seq_to_codes(si),
                siq=qual_str_to_phred(siq),
            )
