"""Scaffold/haplotype FASTA flavors: megabubbles, pseudohap, pseudohap2.

The port's own copy of supernova_tpu/out/pseudohap.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of MakeFasta's ScafLinePrinter walk (10X/tools/MakeFasta.cc:46-57,
175-210; writestuff/ScafLinePrinter.h:301-340):
  * megabubbles — walk each scaffold; megabubble arms become separate
    records, unbranched stretches shared;
  * pseudohap   — one record per scaffold, one arm chosen per bubble
    (phasing choice when phased, stronger arm otherwise);
  * pseudohap2  — two records per scaffold with complementary arm choices
    + a .idx haplotype index (the reference's per-allele `choose`).
Gaps between scaffolded lines are emitted as N runs ({-2} gap edges).
"""
from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Dict

import numpy as np

from ..core import dna
from ..core.kmer_codec import K


def _open(path, mode):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _cell_gap_speller(D):
    """seq_of_path callback for {-4} cell gaps: spell the walked base-edge
    paths (everything chains with K-1 overlaps through shared vertices)."""

    def spell(bpaths) -> str:
        seq = ""
        for p in bpaths:
            for e in p:
                s = D.bg.edge_seq(int(e))
                seq = s if not seq else seq + s[K - 1 :]
        return seq

    return spell


def _walk_edges(walker, D, edges) -> None:
    """Feed D-edges (gap edges included) into a GapAwareWalker."""
    spell = None
    epaths = getattr(D, "epaths", None)  # test fakes carry edge_seq only
    for d in edges:
        row = epaths.row(int(d)) if epaths is not None else ()
        if len(row) and row[0] < 0:
            if spell is None:
                spell = _cell_gap_speller(D)
            walker.add_gap(row, seq_of_path=spell)
        else:
            walker.add_seq(D.edge_seq(int(d)))


def _element_seq(D, el, choice: int) -> str:
    """Sequence of one line element; `choice` picks the path for cells.
    Consecutive D-edges on a cell path overlap by K-1 (gap-aware)."""
    from ..asm.gap import GapAwareWalker

    path = el.paths[min(choice, len(el.paths) - 1)]
    w = GapAwareWalker(K)
    _walk_edges(w, D, path)
    return w.sequence()


def line_sequence(D, line, arm_choice: Dict[int, int]) -> str:
    """Walk a line, overlapping elements by K-1 (N-type gap edges break the
    overlap — Gap.h semantics); arm_choice maps element index -> arm
    (default 0)."""
    from ..asm.gap import GapAwareWalker

    w = GapAwareWalker(K)
    for i, el in enumerate(line.elements):
        path = el.paths[min(arm_choice.get(i, 0), len(el.paths) - 1)]
        _walk_edges(w, D, path)
    return w.sequence()


def _phase_choices(line, phasing, hap: int) -> Dict[int, int]:
    """element idx -> arm for haplotype hap (0/1) from a LinePhasing."""
    out: Dict[int, int] = {}
    for b, bub in enumerate(phasing.bubbles):
        x = int(phasing.x[b])
        if x == 0:
            arm = 0  # unphased: deterministic arm
        else:
            arm = 0 if (x > 0) == (hap == 0) else 1
        out[bub.element_idx] = arm
    return out


def join_parts(parts, sc, k: int | None = None) -> str:
    """Join per-line sequences of a scaffold: Stackaroo fills (sc.fills)
    splice real sequence, otherwise {-2}-style N gaps."""
    from ..asm.patch import PATCH_K

    if k is None:
        k = PATCH_K
    fills = getattr(sc, "fills", None)
    seq = ""
    for i, p in enumerate(parts):
        if i == 0:
            seq = p
            continue
        fill = fills[i - 1] if fills else None
        if fill is not None and len(p) > k:
            seq += fill + p[k:]
        else:
            seq += "N" * sc.gaps[i - 1] + p
    return seq


def _wrap(f, seq: str, width=80):
    for i in range(0, len(seq), width):
        f.write(seq[i : i + width] + "\n")


def write_megabubbles_fasta(D, lines, scaffolds, phasings, path):
    """Each scaffold: unbranched stretches once; both arms of each bubble as
    separate records (the reference's megabubble style)."""
    from ..asm.gap import GapAwareWalker

    rid = 0
    with _open(path, "wt") as f:
        for si, sc in enumerate(scaffolds):
            for li in sc.line_ids:
                line = lines.lines[li]
                w = GapAwareWalker(K)
                seg_id = 0
                for i, el in enumerate(line.elements):
                    if len(el) == 1:
                        _walk_edges(w, D, el.paths[0])
                    else:
                        seg = w.sequence()
                        if seg:
                            f.write(f">scaffold_{si} line_{li} segment_{seg_id}\n")
                            _wrap(f, seg)
                            rid += 1
                            seg_id += 1
                        w = GapAwareWalker(K)
                        for a in range(min(2, len(el))):
                            s = _element_seq(D, el, a)
                            f.write(
                                f">scaffold_{si} line_{li} bubble_{i} arm_{a}\n"
                            )
                            _wrap(f, s)
                            rid += 1
                seg = w.sequence()
                if seg:
                    f.write(f">scaffold_{si} line_{li} segment_{seg_id}\n")
                    _wrap(f, seg)
                    rid += 1
    return rid


def scaffold_records(D, lines, sc, phasings, hap: int):
    """Walk one scaffold in mash mode (ScafLinePrinter::WalkScaffoldLines
    with SetMashMegaBubbles(True), ScafLinePrinter.cc:296-341): cells with
    <= 2 arms contribute the `hap` (choose) arm inline; many-arm cells are
    "busted" — the running record breaks and each arm becomes its own
    record (BustMegabubble, :277-293).  -> [(tag, seq)] with tag "main" or
    "bubble_arm"."""
    records = []
    cur = ""
    fills = getattr(sc, "fills", None)
    from ..asm.patch import PATCH_K

    from ..asm.gap import GapAwareWalker

    for ix, li in enumerate(sc.line_ids):
        line = lines.lines[li]
        phx = phasings.get(li)
        choice = _phase_choices(line, phx, hap) if phx else {}
        w = GapAwareWalker(K)
        busted = False
        for i, el in enumerate(line.elements):
            if len(el.paths) > 2:
                # bust: flush the running record, emit every arm separately
                seg = w.sequence()
                joined = _join_gap(cur, seg, sc, ix, fills, PATCH_K) if not busted else seg
                if joined:
                    records.append(("main", joined))
                for p in el.paths:
                    records.append(("bubble_arm", _path_seq(D, p)))
                cur, busted = "", True
                w = GapAwareWalker(K)
                continue
            _walk_edges(w, D, el.paths[min(choice.get(i, 0), len(el.paths) - 1)])
        seg = w.sequence()
        if busted:
            if seg:
                records.append(("main", seg))
            cur = ""
        else:
            cur = _join_gap(cur, seg, sc, ix, fills, PATCH_K)
    if cur:
        records.append(("main", cur))
    return records


def _path_seq(D, path) -> str:
    from ..asm.gap import GapAwareWalker

    w = GapAwareWalker(K)
    _walk_edges(w, D, path)
    return w.sequence()


def _join_gap(cur: str, seg: str, sc, ix: int, fills, k: int) -> str:
    """Append a line's segment to the running scaffold sequence, splicing
    the preceding gap (Stackaroo fill or N run)."""
    if ix == 0 or not cur:
        return seg if not cur else cur + seg
    fill = fills[ix - 1] if fills else None
    if fill is not None and len(seg) > k:
        return cur + fill + seg[k:]
    return cur + "N" * sc.gaps[ix - 1] + seg


def write_pseudohap_fasta(D, lines, scaffolds, phasings, path):
    """Mashed megabubbles, one allele (choose=0) — MakeFasta.cc:186-193."""
    rid = 0
    with _open(path, "wt") as f:
        for si, sc in enumerate(scaffolds):
            for tag, seq in scaffold_records(D, lines, sc, phasings, 0):
                f.write(f">scaffold_{si}_{rid} {tag} len={len(seq)}\n")
                _wrap(f, seq)
                rid += 1
    return rid


def write_pseudohap2_fasta(D, lines, scaffolds, phasings, path, idx_path=None):
    """Two complementary allele walks + .idx haplotype index
    (MakeFasta.cc:194-210)."""
    index = []
    rid = 0
    with _open(path, "wt") as f:
        for si, sc in enumerate(scaffolds):
            per_hap = {}
            for hap in (0, 1):
                per_hap[hap] = scaffold_records(D, lines, sc, phasings, hap)
            for hap in (0, 1):
                for j, (tag, seq) in enumerate(per_hap[hap]):
                    f.write(
                        f">scaffold_{si}_hap{hap + 1}_{j} {tag} len={len(seq)}\n"
                    )
                    _wrap(f, seq)
                    index.append(
                        {"record": rid, "scaffold": si, "haplotype": hap + 1,
                         "segment": j, "tag": tag}
                    )
                    rid += 1
    if idx_path is None:
        idx_path = str(path).replace(".fasta", ".idx").replace(".gz", "")
    Path(idx_path).write_text(json.dumps(index, indent=1) + "\n")
    return rid
