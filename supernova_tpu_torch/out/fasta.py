"""FASTA emission.

The port's own copy of supernova_tpu/out/fasta.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of the reference's MakeFasta raw flavor (10X/tools/MakeFasta.cc:
143-171: dump every used edge); megabubbles/pseudohap flavors arrive with
the supergraph stages (ScafLinePrinter analogue).
"""
from __future__ import annotations

import gzip
from pathlib import Path


def _open(path, mode):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def write_raw_fasta(bg, path: str | Path, dedupe_rc: bool = True, width: int = 80):
    """Dump edges as FASTA.  With dedupe_rc, keep one edge per rc pair
    (the canonical representative e <= inv[e])."""
    with _open(path, "wt") as f:
        for e in range(bg.n_edges):
            if dedupe_rc and e > int(bg.inv[e]):
                continue
            seq = bg.edge_seq(e)
            f.write(f">edge_{e} len={len(seq)} kmers={bg.kmers(e)} inv={int(bg.inv[e])}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")


def read_fasta(path: str | Path):
    """-> list of (name, seq)."""
    out = []
    name, chunks = None, []
    with _open(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name, chunks = line[1:], []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, "".join(chunks)))
    return out
