"""Misassembly diagnosis: map flagged contigs to the pipeline decision
that created the bad join.

The port's own copy of supernova_tpu/asm/diagnose.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

For every contig whose anchoring shows a second strong same-strand
diagonal (asm/evaluate.py's flag), this tool:
  1. finds the breakpoint(s): positions where the dominant (ref, diagonal)
     vote changes persistently along the contig;
  2. reports the two truth loci and their separation (repeat-join
     signature: both flanks real, locus jump at a repeat copy);
  3. classifies provenance by locating the junction window in the run's
     checkpoints — inside a pre-patch unipath edge (graph.npz), inside a
     patch closure (closures.npz / graph.patched.npz), or only in the
     final sequence (supergraph-level: nucleate glue, overlap merge,
     Stackaroo fill, or bubble mash).

This is a debugging aid over the `a.*`-style npz contract; the reference
has no direct analogue (its astats report counts misassemblies but does
not attribute them)."""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..core import dna
from .evaluate import ANCHOR_K, _ref_index

WIN_STRIDE = 13
JUNCTION_FLANK = 150  # bases kept either side of a breakpoint


@dataclass
class Breakpoint:
    pos: int  # contig position of the diagonal change
    left: Tuple[int, int]  # (ref id, ref pos) before the break
    right: Tuple[int, int]  # (ref id, ref pos) after the break
    separation: int  # |locus jump| when on the same ref
    provenance: str = "unknown"
    junction: str = ""  # junction sequence (2*JUNCTION_FLANK bases)


@dataclass
class ContigDiagnosis:
    name: str
    length: int
    breaks: List[Breakpoint] = field(default_factory=list)


def _window_diagonals(cb: np.ndarray, idx, k: int = ANCHOR_K):
    """(pos, (ref, diag)) per sampled window, restricted to the contig's
    DOMINANT reference (diploid truth makes every window ambiguous across
    haplotypes; the flag we diagnose is a same-ref second diagonal).
    Windows without a unique dominant-ref hit -> None."""
    cbb = cb.tobytes()
    raw = []
    votes: Counter = Counter()
    for p in range(0, len(cb) - k + 1, WIN_STRIDE):
        hits = idx.get(cbb[p : p + k], ())
        raw.append((p, hits))
        for ri, rp in hits:
            votes[ri] += 1
    if not votes:
        return []
    dom = votes.most_common(1)[0][0]
    out = []
    for p, hits in raw:
        on_dom = [(ri, rp) for ri, rp in hits if ri == dom]
        if len(on_dom) == 1:
            ri, rp = on_dom[0]
            out.append((p, (ri, rp - p)))
        else:
            out.append((p, None))
    return out


def _diag_matches(cb, refs, ri, diag, p, k=ANCHOR_K) -> bool:
    """Direct comparison: does the contig window at p match ref ri on
    diagonal `diag`?  (Stride-independent — the anchor index samples only
    every 7th ref position, so absence from the index proves nothing.)"""
    ref = refs[ri]
    q = p + diag
    if q < 0 or q + k > len(ref):
        return False
    return bool(np.array_equal(cb[p : p + k], ref[q : q + k]))


def find_breakpoints(cb: np.ndarray, idx, refs=None) -> List[Breakpoint]:
    """Persistent dominant-diagonal changes along the contig.

    When `refs` is given, a candidate break is kept only if the OLD
    diagonal genuinely stops matching there (direct comparison) — a
    diagonal "change" where the old one still matches is just the strided
    index surfacing a different copy of a repeat."""
    wins = [(p, d) for p, d in _window_diagonals(cb, idx) if d is not None]
    if len(wins) < 2:
        return []
    breaks = []
    i = 0
    while i + 1 < len(wins):
        p0, d0 = wins[i]
        p1, d1 = wins[i + 1]
        if d1 != d0 and (d1[0] != d0[0] or abs(d1[1] - d0[1]) > 50):
            # persistent? the next few windows must stay off d0
            ahead = [d for _, d in wins[i + 1 : i + 6]]
            if all(a != d0 for a in ahead):
                real = True
                if refs is not None:
                    # a real break means NEITHER diagonal explains both
                    # sides: the old one must fail at/after the break AND
                    # the new one must fail before it (otherwise one locus
                    # covers the whole neighborhood — the "change" is just
                    # a repeat copy surfacing in the strided index)
                    real = not _diag_matches(
                        cb, refs, d0[0], d0[1], p1
                    ) and not _diag_matches(cb, refs, d1[0], d1[1], p0)
                if real:
                    sep = abs(d1[1] - d0[1]) if d1[0] == d0[0] else -1
                    breaks.append(
                        Breakpoint(
                            pos=p1,
                            left=(d0[0], p1 + d0[1]),
                            right=(d1[0], p1 + d1[1]),
                            separation=sep,
                        )
                    )
        i += 1
    return breaks


def _seq_contains(hay: str, needle: str) -> bool:
    if needle in hay:
        return True
    rc = dna.codes_to_seq(dna.revcomp(dna.seq_to_codes(needle)))
    return rc in hay


def classify_provenance(junction: str, outdir: Path) -> str:
    """Locate the junction window in run checkpoints, innermost first."""
    from ..dbg.graph import BaseGraph

    checks = []
    g0 = outdir / "graph.npz"
    if g0.exists():
        checks.append(("unipath-edge", BaseGraph.load(g0)))
    gp = outdir / "graph.patched.npz"
    if gp.exists():
        checks.append(("patched-edge", BaseGraph.load(gp)))
    for label, bg in checks:
        for e in range(bg.n_edges):
            if _seq_contains(bg.edge_seq(e), junction):
                return label
    cz = outdir / "closures.npz"
    if cz.exists():
        z = np.load(cz)
        vals, offs = z["values"], z["offsets"]
        for i in range(len(offs) - 1):
            s = dna.codes_to_seq(vals[offs[i] : offs[i + 1]])
            if _seq_contains(s, junction):
                return "patch-closure"
    return "supergraph-level"


def diagnose_assembly(
    fasta_path, truth_paths, outdir, min_len: int = 400
) -> List[ContigDiagnosis]:
    from ..out.fasta import read_fasta

    refs = []
    for p in truth_paths:
        h = np.load(p)
        refs.append(np.asarray(h, np.uint8))
        refs.append(dna.revcomp(h).astype(np.uint8))
    idx = _ref_index(refs)
    out = []
    for name, seq in read_fasta(fasta_path):
        for pi, part in enumerate(seq.split("N")):
            if len(part) < min_len:
                continue
            cb = dna.seq_to_codes(part)
            breaks = find_breakpoints(cb, idx, refs)
            if not breaks:
                continue
            diag = ContigDiagnosis(f"{name}/part{pi}", len(cb))
            for b in breaks:
                lo = max(0, b.pos - JUNCTION_FLANK)
                hi = min(len(part), b.pos + JUNCTION_FLANK)
                b.junction = part[lo:hi]
                if outdir is not None:
                    b.provenance = classify_provenance(
                        b.junction, Path(outdir)
                    )
                diag.breaks.append(b)
            out.append(diag)
    return out


def summarize(diags: List[ContigDiagnosis]) -> Dict[str, int]:
    c: Counter = Counter()
    for d in diags:
        for b in d.breaks:
            c[b.provenance] += 1
    return dict(c)
