"""Assembly statistics report — ReportAssemblyStats analogue.

The port's own copy of supernova_tpu/asm/report.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Computes the reference's summary metric schema
(10X/astats/AssemblyStats.cc:755-800): reads, dup%, phased%, edge/contig/
phase-block/scaffold N50s, assembly size, checksum — written into the
StatLogger so summary.json / summary_cs.csv carry the same fields.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..stats.logger import StatLogger, n50


def nstat(lengths, frac: float) -> int:
    """N-statistic at `frac` (N50 = 0.5, N60 = 0.6 — the reference reports
    both, AssemblyStats.cc:755-800)."""
    ls = np.sort(np.asarray(lengths))[::-1]
    if ls.size == 0:
        return 0
    target = ls.sum() * frac
    return int(ls[np.searchsorted(np.cumsum(ls), target)])


def contig_lengths_from_seq(seq: str) -> List[int]:
    """Split a scaffold sequence at N runs -> contig lengths."""
    out, run = [], 0
    for ch in seq:
        if ch == "N":
            if run:
                out.append(run)
            run = 0
        else:
            run += 1
    if run:
        out.append(run)
    return out


def report_assembly_stats(
    stats: StatLogger,
    D,
    lines,
    scaffolds,
    phasings: Dict[int, object],
    scaffold_seqs: List[str],
    dup_frac: float,
    checksum: int,
):
    edge_lens = np.array([D.edge_len(d) for d in range(D.n_edges)], dtype=np.int64)
    canonical = np.arange(D.n_edges) <= D.dinv
    stats.log("n_super_edges", int(D.n_edges), "supergraph edges", stage="report")
    stats.log(
        "super_edge_N50", n50(edge_lens[canonical]), "supergraph edge N50", cs=True
    )

    contigs: List[int] = []
    for s in scaffold_seqs:
        contigs.extend(contig_lengths_from_seq(s))
    scaff_lens = [len(s) for s in scaffold_seqs]
    stats.log("n_scaffolds", len(scaffolds), "number of scaffolds", cs=True)
    stats.log(
        "scaffolds_10kb_plus",
        int(sum(1 for l in scaff_lens if l >= 10_000)),
        "scaffolds >= 10 kb",
        cs=True,
    )
    stats.log("contig_N50", n50(contigs), "contig N50 (bases)", cs=True)
    stats.log("contig_N60", nstat(contigs, 0.6), "contig N60 (bases)", cs=True)
    stats.log("scaffold_N50", n50(scaff_lens), "scaffold N50 (bases)", cs=True)
    stats.log(
        "scaffold_N60", nstat(scaff_lens, 0.6), "scaffold N60 (bases)", cs=True
    )
    total_with_gaps = int(sum(scaff_lens))
    nonn = int(sum(contigs))
    stats.log(
        "assembly_size",
        nonn,
        "assembly size (non-N bases)",
        cs=True,
    )
    stats.log(
        "gap_perc",
        100.0 * (total_with_gaps - nonn) / total_with_gaps if total_with_gaps else 0.0,
        "% N gap bases in scaffolds",
        cs=True,
    )
    stats.log(
        "bases_in_10kb_scaffolds",
        int(sum(l for l in scaff_lens if l >= 10_000)),
        "bases in scaffolds >= 10 kb",
        cs=True,
    )

    # phasing stats
    pb_lens: List[int] = []
    n_bubbles = 0
    n_phased = 0
    from .phasing import phase_block_lengths

    for li, ph in phasings.items():
        n_bubbles += len(ph.bubbles)
        n_phased += int((ph.x != 0).sum())
        pb_lens.extend(phase_block_lengths(D, lines.lines[li], ph))
    stats.log("n_bubbles", n_bubbles, "het bubbles in lines", stage="report")
    stats.log(
        "phased_perc",
        100.0 * n_phased / n_bubbles if n_bubbles else 0.0,
        "% bubbles phased",
        cs=True,
    )
    stats.log("phase_block_N50", n50(pb_lens), "phase block N50 (bases)", cs=True)
    if n_bubbles:
        stats.log(
            "hetdist",
            int(sum(contigs) / max(n_bubbles, 1)),
            "mean distance between het bubbles",
            cs=True,
        )
    stats.log("dup_perc", 100.0 * dup_frac, "% duplicate read pairs", cs=True)
    # customer-facing (cs=True) like the reference's summary table, which
    # carries the checksum row (AssemblyStats.cc:726,755-800)
    stats.log(
        "assembly_checksum", checksum, "deterministic checksum",
        stage="report", cs=True,
    )
    return stats
