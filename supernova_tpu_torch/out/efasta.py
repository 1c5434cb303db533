"""efasta: FASTA with brace-ambiguity blocks ({ALT1,ALT2,...}).

The port's own copy of supernova_tpu/out/efasta.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference analogue: lib/assembly/src/efasta/ (1,768 LoC) — the reference's
compact diploid representation, where a het site prints as one record with
the alternative alleles in braces instead of two arm records.  The format
here matches the reference's surface grammar (the subset Supernova emits):

    >name
    ACGT{A,C}GGT{AC,}T...

  * plain bases outside braces are homozygous sequence;
  * a brace block lists the alternative alleles (an empty alternative
    encodes an indel);
  * N runs encode gaps exactly as in plain FASTA.

Writer: scaffolds walk like the megabubbles flavor, but bubbles with two
arms become ONE brace block spliced between the flanking homozygous
stretches (arms drop their K-1 overlap with the flanks on both sides,
mirroring GapAwareWalker's splice rule).  Phased bubbles order their
alleles hap0-first, so `expand_haplotype(rec, 0/1)` reproduces the
pseudohap sequences at phased sites.

Parser: `read_efasta` -> (name, [segments]) where a segment is either a
str (homozygous) or a list of alternatives; `flatten` picks allele i
(clamped) for round-trips and tests.
"""
from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, List, Tuple, Union

from ..core.kmer_codec import K

Segment = Union[str, List[str]]


def _open(path, mode):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _element_arms(D, el) -> List[str]:
    from .pseudohap import _element_seq

    return [_element_seq(D, el, a) for a in range(min(2, len(el)))]


def line_segments(D, line, phasing=None) -> List[Segment]:
    """One line -> efasta segments.  Two-arm cells become brace blocks
    (phased blocks order hap0's allele first); other elements extend the
    running homozygous stretch.  Arms and flanks overlap by K-1; the
    brace block carries the arm interior (overlap trimmed both sides)."""
    from ..asm.gap import GapAwareWalker
    from .pseudohap import _walk_edges

    # bubble element -> phasing orientation (+1 keeps arm order, -1 swaps)
    orient: Dict[int, int] = {}
    if phasing is not None:
        for b, bub in enumerate(phasing.bubbles):
            x = int(phasing.x[b])
            if x != 0:
                orient[bub.element_idx] = x

    segs: List[Segment] = []
    w = GapAwareWalker(K)
    started = False  # True once some element flowed into `w`
    for i, el in enumerate(line.elements):
        if len(el) < 2:
            _walk_edges(w, D, el.paths[0])
            started = True
            continue
        arms = _element_arms(D, el)
        left = w.sequence()
        # arms overlap the left flank by K-1 and the right flank by K-1;
        # keep the overlap on the flanks, put the interior in the block
        trim_l = K - 1 if started and left else 0
        alts = []
        for a in arms:
            core = a[trim_l:]
            core = core[: max(len(core) - (K - 1), 0)]
            alts.append(core)
        if int(orient.get(i, 1)) < 0:
            alts = alts[::-1]
        if left:
            segs.append(left)
        segs.append(alts)
        # restart the walker seeded with the arm's right K-1 overlap so the
        # next homozygous stretch keeps its bases exactly once
        w = GapAwareWalker(K)
        tail = arms[0][max(len(arms[0]) - (K - 1), 0):]
        if tail:
            w.add_seq(tail)
        started = bool(tail)
    tail_seq = w.sequence()
    if tail_seq:
        segs.append(tail_seq)
    return segs


def write_efasta(D, lines, scaffolds, phasings, path) -> int:
    """Scaffold-per-record efasta; {-2}-style N gaps between lines (the
    join rule of pseudohap.join_parts, without Stackaroo splice blocks —
    fills are already sequence and print as homozygous bases)."""
    n = 0
    with _open(path, "wt") as f:
        for si, sc in enumerate(scaffolds):
            parts: List[List[Segment]] = []
            for li in sc.line_ids:
                segs = line_segments(
                    D, lines.lines[li], phasings.get(li)
                )
                parts.append(segs)
            f.write(f">scaffold_{si}\n")
            out: List[str] = []
            for i, segs in enumerate(parts):
                if i:
                    gap = sc.gaps[i - 1] if sc.gaps else 100
                    out.append("N" * max(int(gap), 1))
                for s in segs:
                    if isinstance(s, str):
                        out.append(s)
                    else:
                        out.append("{" + ",".join(s) + "}")
            text = "".join(out)
            for j in range(0, len(text), 80):
                f.write(text[j : j + 80] + "\n")
            n += 1
    return n


def read_efasta(path) -> List[Tuple[str, List[Segment]]]:
    out: List[Tuple[str, List[Segment]]] = []
    name = None
    buf: List[str] = []

    def finish():
        if name is None:
            return
        text = "".join(buf)
        segs: List[Segment] = []
        i = 0
        while i < len(text):
            if text[i] == "{":
                j = text.index("}", i)
                segs.append(text[i + 1 : j].split(","))
                i = j + 1
            else:
                j = text.find("{", i)
                if j < 0:
                    j = len(text)
                segs.append(text[i:j])
                i = j
        out.append((name, segs))

    with _open(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                finish()
                name = line[1:].split()[0]
                buf = []
            else:
                buf.append(line)
    finish()
    return out


def flatten(segments: List[Segment], allele: int = 0) -> str:
    """Expand one haplotype: pick `allele` (clamped) in every block."""
    parts = []
    for s in segments:
        if isinstance(s, str):
            parts.append(s)
        else:
            parts.append(s[min(allele, len(s) - 1)])
    return "".join(parts)
