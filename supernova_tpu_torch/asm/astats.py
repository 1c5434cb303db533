"""Reference-genome assembly statistics — the astats family.

The port's own copy of supernova_tpu/asm/astats.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogues of 10X/astats/: GenomeAlign builds per-sequence placements on
the reference by perfect-kmer anchoring (GenomeAlign.cc:1-232, K=80);
Misassembly decomposes placement error into *distant* (wrong
chromosome / far from the scaffold's best home), *orientation*
(minority strand inside the home) and *order* (out-of-order blocks)
components, each as a kmer-weighted rate (Misassembly.cc:11-160);
MeasureGaps compares each scaffold gap's recorded size against the true
distance between the flanking contigs' reference placements
(MeasureGaps.cc:14-140).  AssemblyStats.cc:619-655 sums the three rates
into the headline `misassembly` metric.

Views here are computed from assembled sequences + truth haplotype code
arrays (the simulation path); the reference computes them from
`alignsb` per-edge alignments, but the downstream math is the same.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core import dna

ANCHOR_K = 80  # GenomeAlign.cc perfect-kmer K
TOO_FAR = 300_000  # Misassembly.cc:19 home-interval clustering gap


@dataclass
class Placement:
    """One aligned block of a scaffold (the reference's `view` quad:
    (genome-id, fw, ref-interval, scaffold-interval) —
    AssemblyStats.cc:233-252)."""
    ref: int  # haplotype id (strand folded away)
    fw: bool
    ref_start: int
    ref_stop: int
    seq_start: int
    seq_stop: int

    @property
    def length(self) -> int:
        return self.ref_stop - self.ref_start


def build_ref_index(haps: Sequence[np.ndarray], k: int = ANCHOR_K,
                    stride: int = 1, fold: bool = False):
    """fw+rc perfect-kmer index over the truth haplotypes.

    With fold=True (diploid SNP-only truth: haplotypes share
    coordinates), homologous anchors from different haplotypes collapse
    to one (ref=0, pos) coordinate system — the haploid-reference view
    the reference's GenomeAlign assumes."""
    refs = []
    for h in haps:
        refs.append(np.asarray(h, np.uint8))
        refs.append(dna.revcomp(h).astype(np.uint8))
    if fold:
        assert len({len(h) for h in haps}) == 1, "fold needs equal lengths"
    idx: Dict[bytes, List[Tuple[int, int]]] = defaultdict(list)
    for ri, ref in enumerate(refs):
        rb = ref.tobytes()
        fri = ri % 2 if fold else ri
        for p in range(0, len(rb) - k + 1, stride):
            ent = idx[rb[p: p + k]]
            if not (fold and (fri, p) in ent):
                ent.append((fri, p))
    if fold:
        refs = refs[:2]
    return refs, idx


def contig_placements(seq: np.ndarray, refs, idx, k: int = ANCHOR_K,
                      seq_offset: int = 0) -> List[Placement]:
    """Anchor a contig and emit maximal same-diagonal placements
    (GenomeAlign's aligns; unique-kmer anchoring + run merging)."""
    sb = np.asarray(seq, np.uint8).tobytes()
    n = len(seq)
    if n < k:
        return []
    hits: List[Tuple[int, int, int]] = []  # (ri, diag, pos)
    for p in range(0, n - k + 1):
        cands = idx.get(sb[p: p + k])
        if cands and len(cands) == 1:  # unique anchors only
            ri, rp = cands[0]
            hits.append((ri, rp - p, p))
    if not hits:
        return []
    hits.sort()
    placements = []
    i = 0
    while i < len(hits):
        ri, diag, p0 = hits[i]
        j = i
        pend = p0
        while (j + 1 < len(hits) and hits[j + 1][0] == ri
               and hits[j + 1][1] == diag
               and hits[j + 1][2] - pend <= k):
            j += 1
            pend = hits[j][2]
        seq_a, seq_b = p0, pend + k
        ref_a, ref_b = seq_a + diag, seq_b + diag
        # fold rc strands (odd ri) back to fw coordinates
        hap, is_fw = ri // 2, (ri % 2 == 0)
        if not is_fw:
            rlen = len(refs[ri])
            ref_a, ref_b = rlen - ref_b, rlen - ref_a
        placements.append(Placement(hap, is_fw, ref_a, ref_b,
                                    seq_offset + seq_a, seq_offset + seq_b))
        i = j + 1
    # scaffold-coordinate order (the reference walks lines in order, so
    # the order-error metric depends on views being seq-ordered)
    placements.sort(key=lambda p: (p.seq_start, p.seq_stop))
    return placements


def scaffold_view(scaffold: np.ndarray, refs, idx, k: int = ANCHOR_K,
                  gap_code: int = 4):
    """Split a scaffold at N runs and place every contig; -> (view,
    gaps) where gaps[g] = (n_run_len, left_contig_idx, right_contig_idx)
    into the view list (the MakeFasta raw-N convention)."""
    codes = np.asarray(scaffold, np.uint8)
    is_gap = codes >= gap_code
    view: List[Placement] = []
    gaps: List[Tuple[int, int, int]] = []
    bounds = np.flatnonzero(np.diff(np.r_[1, is_gap.view(np.int8), 1]))
    # bounds pairs: [contig_start, contig_end) alternating with gap runs
    segs = [(int(bounds[i]), int(bounds[i + 1]))
            for i in range(0, len(bounds) - 1, 2)]
    pending: List[Tuple[int, int]] = []  # (n_run, left placement idx)
    prev_end = None
    for a, b in segs:
        if prev_end is not None:
            pending.append((a - prev_end, len(view) - 1))
        pls = contig_placements(codes[a:b], refs, idx, k, seq_offset=a)
        if pls:
            if pending:
                # unanchored middles collapse into one flank-pair record
                gaps.append((sum(g for g, _ in pending), pending[0][1],
                             len(view)))
            pending = []
        view.extend(pls)
        prev_end = b
    return view, gaps


def misassembly_errors(views: Sequence[Sequence[Placement]],
                       too_far: int = TOO_FAR) -> Dict[str, float]:
    """The three kmer-weighted error rates + their sum
    (Misassembly.cc:11-160, AssemblyStats.cc:619-655)."""
    dis_n = dis_d = ori_n = ori_d = ord_n = ord_d = 0
    for view in views:
        if not view:
            continue
        # best home: cluster placements per ref within too_far, pick the
        # most massive cluster (Misassembly.cc:19-49)
        homer = sorted((p.ref, p.ref_start, p.length) for p in view)
        inters = []
        i = 0
        while i < len(homer):
            chrom, start, ln = homer[i]
            stop = start + ln
            mass = ln
            j = i + 1
            while (j < len(homer) and homer[j][0] == chrom
                   and homer[j][1] - stop <= too_far):
                stop = max(stop, homer[j][1] + homer[j][2])
                mass += homer[j][2]
                j += 1
            inters.append((mass, chrom, start, stop))
            i = j
        mass, chrom, start, stop = max(inters)
        # distant errors
        for p in view:
            dis_d += p.length
            if p.ref != chrom or p.ref_start < start or p.ref_stop > stop:
                dis_n += p.length
        # orientation errors (inside home only)
        inside = [p for p in view
                  if p.ref == chrom and p.ref_start >= start
                  and p.ref_stop <= stop]
        fwn = sum(p.length for p in inside if p.fw)
        rcn = sum(p.length for p in inside if not p.fw)
        is_fw = fwn >= rcn
        ori_n += rcn if is_fw else fwn
        ori_d += fwn + rcn
        # order errors (survivors of dis+ori; iterated worst-block kill,
        # Misassembly.cc:85-160)
        vord = []  # (pos, kmers, scaffold-order-id)
        for p in inside:
            if p.fw != is_fw:
                continue
            pos = p.ref_start if is_fw else -p.ref_start
            vord.append((pos, p.length, len(vord)))
        ord_d += sum(v[1] for v in vord)
        vords = sorted(vord)
        blocks = []  # (first_id, pos, kmers)
        i = 0
        while i < len(vords):
            nk = vords[i][1]
            j = i + 1
            while j < len(vords) and vords[j][2] == vords[j - 1][2] + 1:
                nk += vords[j][1]
                j += 1
            blocks.append([vords[i][2], vords[i][0], nk])
            i = j
        blocks.sort()
        while blocks:
            mis = [0] * len(blocks)
            for a in range(len(blocks)):
                for b in range(len(blocks)):
                    if (b < a and blocks[b][1] > blocks[a][1]) or (
                            b > a and blocks[b][1] < blocks[a][1]):
                        mis[a] += blocks[b][2]
            worst = max(range(len(blocks)), key=lambda x: mis[x])
            if mis[worst] == 0:
                break
            ord_n += blocks[worst][2]
            del blocks[worst]
    out = {
        "dis_err_perc": 100.0 * dis_n / dis_d if dis_d else 0.0,
        "ori_err_perc": 100.0 * ori_n / ori_d if ori_d else 0.0,
        "ord_err_perc": 100.0 * ord_n / ord_d if ord_d else 0.0,
    }
    out["misassembly_rate_perc"] = (
        out["dis_err_perc"] + out["ori_err_perc"] + out["ord_err_perc"])
    return out


def measure_gaps(views_and_gaps) -> List[Tuple[int, int]]:
    """-> [(recorded_gap, true_gap)] for every scaffold gap whose two
    flanking contigs anchor to the same haplotype/strand
    (MeasureGaps.cc: predicted vs alignment-implied gap).  Both values
    are measured between the same two anchored blocks: recorded = the
    scaffold-coordinate distance (N run + unanchored contig overhang),
    true = the reference-coordinate distance."""
    out = []
    for view, gaps in views_and_gaps:
        for n_run, li, ri in gaps:
            if li < 0 or ri >= len(view):
                continue
            L, R = view[li], view[ri]
            if L.ref != R.ref or L.fw != R.fw:
                continue
            rec = R.seq_start - L.seq_stop
            if L.fw:
                true_gap = R.ref_start - L.ref_stop
            else:
                true_gap = L.ref_start - R.ref_stop
            out.append((int(rec), int(true_gap)))
    return out


def gap_stats(pairs: Sequence[Tuple[int, int]]) -> Dict[str, float]:
    if not pairs:
        return {"n_gaps_measured": 0}
    rec = np.array([p[0] for p in pairs], float)
    true = np.array([p[1] for p in pairs], float)
    dev = rec - true
    return {
        "n_gaps_measured": len(pairs),
        "gap_dev_mean": float(dev.mean()),
        "gap_dev_abs_median": float(np.median(np.abs(dev))),
        "gap_frac_within_1kb": float((np.abs(dev) <= 1000).mean()),
    }


def evaluate_scaffolds(scaffolds: Sequence[np.ndarray],
                       haplotypes: Sequence[np.ndarray],
                       k: int = ANCHOR_K, fold: bool | None = None,
                       too_far: int = TOO_FAR) -> Dict[str, float]:
    """Full astats pass over N-gapped scaffold code arrays.  fold
    defaults to True when the haplotypes share a coordinate system
    (equal lengths — the SNP-only diploid sim truth)."""
    if fold is None:
        fold = len({len(h) for h in haplotypes}) == 1
    refs, idx = build_ref_index(haplotypes, k, fold=fold)
    vg = [scaffold_view(s, refs, idx, k) for s in scaffolds]
    out = misassembly_errors([v for v, _ in vg], too_far=too_far)
    out.update(gap_stats(measure_gaps(vg)))
    return out
