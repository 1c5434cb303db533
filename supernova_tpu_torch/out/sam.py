"""SAM export of read placements on the assembly graph.

The port's own copy of supernova_tpu/out/sam.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

The reference's internal QA path aligns reads with BWA into BAM and
decorates them (_ALIGNER/_BCSORTER: mro/_aligner.mro:31, attach_bcs,
mark_duplicates; BAM support lib lib/assembly/src/bam/).  Here reads are
already aligned to the assembly by the native pather, so the analogue is an
export: each read's graph placement as a SAM record against the base-graph
edges, with the 10x BX barcode tag and the full edge path in XP.

Records are match/soft-clip CIGARs against the read's FIRST edge (SAM has
no multi-reference alignment; the continuation across edges is carried in
XP:Z as a comma-separated edge list).  Mates are flagged paired, with
proper-pair set when both mates placed (the proper_pairs_perc metric uses
stricter insert gating — this flag is the simple both-placed QA bit).
"""
from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from ..core import dna


def _open(path, mode="wt"):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode)
    return open(p, mode)


def write_sam(
    path,
    bg,
    rs,
    edges: np.ndarray,      # (R, MAX_PATH) int32, -1 pad
    plen: np.ndarray,       # (R,)
    offset: np.ndarray,     # (R,)
    dup: np.ndarray | None = None,   # (R//2,) or (R,) bool, optional
    sample: str = "sample",
    whitelist: np.ndarray | None = None,  # (W, 16) base codes for BX seqs
) -> int:
    """Write placements as SAM (gzip when path ends .gz).  Returns the
    number of records written (= n_reads)."""
    edges = np.asarray(edges)
    plen = np.asarray(plen)
    offset = np.asarray(offset)
    elen = bg.edges.lengths()
    n = rs.n_reads
    if dup is not None:
        dup = np.asarray(dup)
        if len(dup) * 2 == n:
            dup = np.repeat(dup, 2)
    written = 0
    with _open(path) as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for e in range(bg.n_edges):
            f.write(f"@SQ\tSN:edge_{e}\tLN:{int(elen[e])}\n")
        f.write(f"@RG\tID:{sample}\tSM:{sample}\n")
        f.write(
            "@PG\tID:supernova_tpu\tPN:supernova_tpu\tDS:graph placements\n"
        )
        for i in range(n):
            mate = i ^ 1 if (i ^ 1) < n else i
            mapped = plen[i] > 0
            m_mapped = plen[mate] > 0
            flag = 1 | (64 if i % 2 == 0 else 128)
            if not mapped:
                flag |= 4
            if not m_mapped:
                flag |= 8
            if mapped and m_mapped:
                flag |= 2
            if dup is not None and dup[i]:
                flag |= 1024
            seq_codes = rs.read(i)
            rlen = len(seq_codes)
            quals = rs.qual(i)
            if mapped:
                e0 = int(edges[i, 0])
                off = int(offset[i])
                lead = max(-off, 0)
                pos0 = max(off, 0)
                span = max(min(rlen - lead, int(elen[e0]) - pos0), 0)
                tail = rlen - lead - span
                cig = ""
                if lead:
                    cig += f"{lead}S"
                cig += f"{span}M" if span else "*"
                if tail:
                    cig += f"{tail}S"
                rname, pos, mapq = f"edge_{e0}", pos0 + 1, 60
            else:
                rname, pos, mapq, cig = "*", 0, 0, "*"
            if m_mapped:
                rnext = f"edge_{int(edges[mate, 0])}"
                if mapped and edges[mate, 0] == edges[i, 0]:
                    rnext = "="
                pnext = max(int(offset[mate]), 0) + 1
            else:
                rnext, pnext = "*", 0
            tags = [f"RG:Z:{sample}"]
            if rs.barcoded and rs.bc[i] > 0:
                b = int(rs.bc[i])
                if whitelist is not None and b - 1 < len(whitelist):
                    tags.append(
                        "BX:Z:" + dna.codes_to_seq(whitelist[b - 1]) + "-1"
                    )
                else:
                    tags.append(f"BX:Z:bc{b}-1")
            if mapped and plen[i] > 1:
                tags.append(
                    "XP:Z:" + ",".join(
                        str(int(e)) for e in edges[i, : plen[i]]
                    )
                )
            f.write(
                "\t".join(
                    (
                        f"{sample}:{i // 2}",
                        str(flag),
                        rname,
                        str(pos),
                        str(mapq),
                        cig,
                        rnext,
                        str(pnext),
                        "0",
                        dna.codes_to_seq(seq_codes),
                        "".join(chr(int(q) + 33) for q in quals),
                        *tags,
                    )
                )
                + "\n"
            )
            written += 1
    return written


def export_sam_from_run(outdir, sam_path, sample: str = "sample") -> int:
    """Load the reads/graph/paths checkpoints of a finished run and export
    SAM (the CLI `sam` subcommand)."""
    from ..align import pathzip
    from ..dbg.graph import BaseGraph
    from ..ingest.reads import ReadSet

    outdir = Path(outdir)
    rs = ReadSet.load(outdir / "reads.npz")
    z = np.load(outdir / "paths.npz")
    n_edges = int(z["n_edges"]) if "n_edges" in z else None
    bg = None
    for name in ("graph.patched.npz", "graph.npz"):
        p = outdir / name
        if p.exists():
            cand = BaseGraph.load(p)
            if n_edges is None or cand.n_edges == n_edges:
                bg = cand
                break
    if bg is None:
        raise FileNotFoundError(
            f"no graph checkpoint matching paths.npz in {outdir}"
        )
    if "edges" in z:  # legacy dense checkpoint format
        edges, plen, offset = z["edges"], z["path_len"], z["offset"]
    else:
        edges, plen, offset = pathzip.load_zipped(z, bg)
    return write_sam(
        sam_path, bg, rs, np.asarray(edges), np.asarray(plen),
        np.asarray(offset), sample=sample,
    )
