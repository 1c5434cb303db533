"""Stackaroo: read-based post patching of scaffold gaps.

The port's own copy of supernova_tpu/asm/stackaroo.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of 10X/Stackaroo.cc (read-stack patching over the smart
placements, CP.cc:1286-1288): after scaffolding, each {-2} barcode-only
gap between joined lines is attacked with the reads placed near the two
flanking line ends (plus their mates); a small-k DBG walk from the left
flank's tail to the right flank's head (the Stackster-style consensus,
shared with asm/patch) converts the gap into sequence when the reads
bridge it.  Successful fills replace the N run in every FASTA flavor.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .patch import PATCH_K, _mini_dbg_walk

FLANK_BASES = 400  # anchor context taken from each line end
# wider context for fill VERIFICATION (not the walk): the sim's repeat
# units (and real interspersed repeats) reach ~400 bases, so 400-base
# flanks can be pure repeat at a seam — contradictions from flank-anchored
# mates only fire when the UNIQUE zone beyond the repeat is inside J
VERIFY_CTX = 1000
MAX_GAP_READS = 400


def reads_by_line(lines, dpaths: np.ndarray, dlen: np.ndarray) -> Dict[int, List[int]]:
    """line id -> read ids placed on it (first placed D-edge), vectorized."""
    r, mp = dpaths.shape
    dlen = np.asarray(dlen)[:r]
    loe = np.asarray(lines.line_of_edge)
    valid = (np.arange(mp)[None, :] < dlen[:, None]) & (dpaths >= 0)
    first = np.argmax(valid, axis=1)
    has = valid[np.arange(r), first]
    d0 = dpaths[np.arange(r), first]
    li = np.where(has, loe[np.clip(d0, 0, len(loe) - 1)], -1)
    out: Dict[int, List[int]] = {}
    keep = li >= 0
    order = np.argsort(li[keep], kind="stable")
    rids = np.nonzero(keep)[0][order]
    lis = li[keep][order]
    if len(lis):
        starts = np.concatenate([[0], np.nonzero(lis[1:] != lis[:-1])[0] + 1, [len(lis)]])
        for a, b in zip(starts[:-1], starts[1:]):
            out[int(lis[a])] = rids[a:b].tolist()
    return out


def _fill_contradicts_estimate(fill_len: int, gap_row) -> bool:
    """A stack bridge much SHORTER than the gap's molecule-evidence size
    is a repeat-flank artifact: both flanks end in copies of a repeat, the
    mini-DBG walks flank-to-flank through it, and the 'closure' skips the
    real genome in between (observed at the 10 Mb rung: a {-2, 10000}
    gap 'closed' by 400 bases whose window then evaluates ori-class).
    Reject when est - fill > max(4 kb, 0.75 * est); longer-than-estimate
    fills stay.  Only CALIBRATED sizes are trusted (row [-2, size, 1],
    written by the gaprika presize phase) — judging against the crude
    star-time cap rejected ~240 mostly-good fills at the 10 Mb rung and
    pushed them to worse unvoid grafts (ori 0.23% -> 4.0%)."""
    row = np.asarray(gap_row)
    if len(row) < 3 or row[0] != -2 or row[2] != 1:
        return False
    est = int(row[1])
    return (est - fill_len) > max(4_000, (3 * est) // 4)


def stackaroo_gaps(
    D,
    rs,
    dpaths: np.ndarray,
    dlen: np.ndarray,
    k: int = PATCH_K,
    ownership=None,
):
    """Gap-edge Stackaroo: attack every canonical {-2} barcode-only gap edge
    in D with the reads placed on its flanking D-edges (+ mates); a bridging
    read-stack walk upgrades the edge to a {-3} sequence gap (ltrim=rtrim=0,
    K-1 overlap with both neighbors — Gap.h:28-43).  Returns
    (new SuperGraph, n_upgraded); D is unchanged when nothing fills."""
    from ..core import dna
    from ..core.kmer_codec import K
    from ..core.ragged import Ragged
    from . import gap as agap
    from .supergraph import SuperGraph

    gap_ids = [
        d
        for d in range(D.n_edges)
        if d <= int(D.dinv[d]) and agap.is_bc_gap(D.epaths.row(d))
        and int(D.dinv[d]) != d
    ]
    if not gap_ids:
        return D, 0

    # neighbor edges: unique non-gap edge into from_v / out of to_v
    into: Dict[int, List[int]] = {}
    outof: Dict[int, List[int]] = {}
    for e in range(D.n_edges):
        into.setdefault(int(D.to_v[e]), []).append(e)
        outof.setdefault(int(D.from_v[e]), []).append(e)

    r, mp = dpaths.shape
    dl = np.asarray(dlen)[:r]
    valid = (np.arange(mp)[None, :] < dl[:, None]) & (dpaths >= 0)

    # inverted placement index (edge -> read ids), built ONCE: the old
    # per-gap np.isin over the whole (R, MAX_PATH) matrix was the 10 Mb
    # scaffold wall (each gap re-scanned 38M cells)
    flat_r, flat_c = np.nonzero(valid)
    flat_e = dpaths[flat_r, flat_c]
    order = np.argsort(flat_e, kind="stable")
    idx_e = flat_e[order]
    idx_r = flat_r[order]

    def reads_on(edges: List[int]) -> set:
        out: set = set()
        for e in edges:
            lo, hi = np.searchsorted(idx_e, [e, e + 1])
            out.update(idx_r[lo:hi].tolist())
        return out

    from ..core import dna as _dna

    ctx = max(FLANK_BASES, K)
    replacements: Dict[int, np.ndarray] = {}
    n_filled = 0
    n_rejected = 0
    reject_reasons: List[str] = []
    owned_fracs: List[float] = []
    for d in gap_ids:
        lefts = [e for e in into.get(int(D.from_v[d]), []) if not D.is_gap(e)]
        rights = [e for e in outof.get(int(D.to_v[d]), []) if not D.is_gap(e)]
        if len(lefts) != 1 or len(rights) != 1:
            continue  # {-3} requires exactly one abutting edge per side
        eL, eR = lefts[0], rights[0]
        # flank-sized context only — full edge_seq is O(edge length)
        vctx_l = D.edge_tail_bases(eL, max(ctx, VERIFY_CTX))
        vctx_r = D.edge_head_bases(eR, max(ctx, VERIFY_CTX))
        codes_l = vctx_l[-ctx:]
        codes_r = vctx_r[:ctx]
        seq_l = _dna.codes_to_seq(codes_l)
        seq_r = _dna.codes_to_seq(codes_r)
        if len(seq_l) < K or len(seq_r) < K:
            continue
        rids = reads_on([eL, eR, int(D.dinv[eL]), int(D.dinv[eR])])
        rids |= {rid ^ 1 for rid in rids}  # mates dangle into the gap
        rids = sorted(rids)[:MAX_GAP_READS]
        if len(rids) < 2:
            continue
        seqs = [rs.read(rid) for rid in rids]
        left = seq_l[-FLANK_BASES:]
        right = seq_r[:FLANK_BASES]
        fill = _mini_dbg_walk(seqs, left, right, k)
        if fill is None or len(fill) < k:
            continue  # len >= k guarantees the tail-(K-1) equals eR's head
        if _fill_contradicts_estimate(len(fill), D.epaths.row(d)):
            continue
        if len(fill) > k:
            # content fill: demand read-PAIR support through it — wrong-copy
            # fills are barcode-continuous and position-correct, only the
            # pair content betrays them (asm/fillcheck.py)
            from . import fillcheck as afc

            ok, vinfo = afc.verify_fill(
                vctx_l, dna.seq_to_codes(fill[:-k]), vctx_r, rs, rids,
                ownership=ownership,
            )
            of = afc.fill_owned_frac(
                dna.seq_to_codes(fill[:-k]), ownership
            ) if ownership is not None else None
            if of is not None:
                owned_fracs.append(round(of, 3))
            if not ok:
                n_rejected += 1
                reject_reasons.append(vinfo.get("reason", "pairs"))
                continue
        # {-3} payload: starts with eL's last K-1 bases, ends with eR's
        # first K-1 (fill already ends with right[:k])
        gseq = seq_l[-(K - 1) :] + fill + right[k : K - 1]
        row = agap.seq_to_gap(dna.seq_to_codes(gseq), 0, 0)
        replacements[d] = row
        replacements[int(D.dinv[d])] = agap.rc_gap(row)
        n_filled += 1

    import logging

    _log = logging.getLogger("supernova_tpu")
    if n_rejected:
        from collections import Counter

        _log.info(
            "stackaroo: %d fills rejected (kept {-2}): %s",
            n_rejected, dict(Counter(reject_reasons)),
        )
    if owned_fracs:
        of = np.asarray(owned_fracs)
        _log.info(
            "stackaroo: owned-frac over %d judged fills: median %.3f, "
            ">0.5: %d", len(of), float(np.median(of)),
            int((of > 0.5).sum()),
        )
    if not replacements:
        return D, 0
    rows = [replacements.get(d, D.epaths.row(d)) for d in range(D.n_edges)]
    D2 = SuperGraph(
        epaths=Ragged.from_rows(rows, dtype=np.int64),
        dinv=D.dinv.copy(),
        from_v=D.from_v.copy(),
        to_v=D.to_v.copy(),
        n_vertices=D.n_vertices,
        bg=D.bg,
    )
    return D2, n_filled


def audit_seq_gaps(D, rs, dpaths, dlen, ownership=None):
    """Final fill-content audit over EVERY canonical {-3} sequence gap.

    {-3} rows enter D from several creators (stackaroo upgrades, unvoid
    linear closures, branched closure grafts, splat) and the graph mutates
    under later surgeries — so the emission-time D is the only place all
    of them can be judged consistently against the CURRENT placements.
    Rows that fail the pair-content check (asm/fillcheck.verify_fill)
    demote to calibrated {-2} rows of the same length: the scaffold join
    survives, the contested content prints as Ns, and the evaluation
    window that a wrong-copy fill would poison never exists.  Returns
    (D, n_demoted)."""
    from ..core import dna
    from ..core.kmer_codec import K
    from ..core.ragged import Ragged
    from . import fillcheck as afc
    from . import gap as agap
    from .supergraph import SuperGraph

    targets = [
        d for d in range(D.n_edges)
        if d <= int(D.dinv[d]) and int(D.dinv[d]) != d
        and len(D.epaths.row(d)) and int(D.epaths.row(d)[0]) == -3
    ]
    if not targets:
        return D, 0
    into: Dict[int, List[int]] = {}
    outof: Dict[int, List[int]] = {}
    for e in range(D.n_edges):
        into.setdefault(int(D.to_v[e]), []).append(e)
        outof.setdefault(int(D.from_v[e]), []).append(e)
    r, mp = dpaths.shape
    dl = np.asarray(dlen)[:r]
    valid = (np.arange(mp)[None, :] < dl[:, None]) & (dpaths >= 0)
    flat_r, flat_c = np.nonzero(valid)
    flat_e = dpaths[flat_r, flat_c]
    order = np.argsort(flat_e, kind="stable")
    idx_e = flat_e[order]
    idx_r = flat_r[order]

    def reads_on(edges: List[int]) -> set:
        out: set = set()
        for e in edges:
            lo, hi = np.searchsorted(idx_e, [e, e + 1])
            out.update(idx_r[lo:hi].tolist())
        return out

    from .gap import GapAwareWalker

    replacements: Dict[int, np.ndarray] = {}
    skip = {"flanks": 0, "short": 0, "reads": 0}
    n_judged = 0
    for d in targets:
        lefts = [e for e in into.get(int(D.from_v[d]), []) if not D.is_gap(e)]
        rights = [e for e in outof.get(int(D.to_v[d]), []) if not D.is_gap(e)]
        if len(lefts) != 1 or len(rights) != 1:
            skip["flanks"] += 1
            continue
        eL, eR = lefts[0], rights[0]
        w = GapAwareWalker(K)
        w.add_gap(D.epaths.row(d))
        payload = dna.seq_to_codes(w.sequence())
        if len(payload) < 2 * (K - 1) + K + 8:
            skip["short"] += 1
            continue  # too little novel content to judge
        novel = payload[K - 1 : len(payload) - (K - 1)]
        rids = reads_on([eL, eR, int(D.dinv[eL]), int(D.dinv[eR])])
        rids |= {rid ^ 1 for rid in rids}
        rids = sorted(rids)[:MAX_GAP_READS]
        if len(rids) < 2:
            skip["reads"] += 1
            continue
        n_judged += 1
        ok, _info = afc.verify_fill(
            D.edge_tail_bases(eL, VERIFY_CTX), novel,
            D.edge_head_bases(eR, VERIFY_CTX), rs, rids,
            ownership=ownership,
        )
        if ok:
            continue
        row = np.array([-2, max(1, len(novel)), 1], np.int64)
        replacements[d] = row
        replacements[int(D.dinv[d])] = row.copy()
    import logging as _logging

    _logging.getLogger("supernova_tpu").info(
        "audit: %d {-3} rows, %d judged, %d demoted, skipped %s",
        len(targets), n_judged, len(replacements) // 2, skip,
    )
    if not replacements:
        return D, 0
    rows = [replacements.get(d, D.epaths.row(d)) for d in range(D.n_edges)]
    D2 = SuperGraph(
        epaths=Ragged.from_rows(rows, dtype=np.int64),
        dinv=D.dinv.copy(),
        from_v=D.from_v.copy(),
        to_v=D.to_v.copy(),
        n_vertices=D.n_vertices,
        bg=D.bg,
    )
    return D2, len(replacements) // 2


def stackaroo(
    D,
    lines,
    scaffolds,
    rs,
    dpaths: np.ndarray,
    dlen: np.ndarray,
    line_seqs: Dict[int, str],
    k: int = PATCH_K,
    ownership=None,
) -> int:
    """Fill scaffold gaps in place (sets sc.fills[i]); -> gaps filled."""
    rbl = reads_by_line(lines, dpaths, dlen)
    linv = lines.linv
    n_filled = 0
    n_rejected = 0
    for sc in scaffolds:
        if getattr(sc, "fills", None) is None:
            sc.fills = [None] * len(sc.gaps)
        for i in range(len(sc.line_ids) - 1):
            la, lb = sc.line_ids[i], sc.line_ids[i + 1]
            seq_a = line_seqs.get(la)
            seq_b = line_seqs.get(lb)
            if not seq_a or not seq_b or len(seq_a) < k or len(seq_b) < k:
                continue
            rids: List[int] = []
            for li in (la, int(linv[la]), lb, int(linv[lb])):
                rids.extend(rbl.get(li, ()))
            # include mates (the fragment may dangle into the gap)
            with_mates = set()
            for r in rids:
                with_mates.add(r)
                with_mates.add(r ^ 1)
            rids = sorted(with_mates)[:MAX_GAP_READS]
            if len(rids) < 2:
                continue
            seqs = [rs.read(r) for r in rids]
            left = seq_a[-FLANK_BASES:]
            right = seq_b[:FLANK_BASES]
            fill = _mini_dbg_walk(seqs, left, right, k)
            if fill is None:
                continue
            if len(fill) > k:
                # post-scaffold fills splice CONTINUOUS sequence into the
                # emitted FASTA — the wrong-copy escape hatch of the 10 Mb
                # rung (164 ungated fills; raw flavor clean, pseudohap ori
                # 0.37%).  Same pair-content gate as the gap-edge path.
                from ..core import dna as _dna
                from . import fillcheck as afc

                ok, _info = afc.verify_fill(
                    _dna.seq_to_codes(seq_a[-VERIFY_CTX:]),
                    _dna.seq_to_codes(fill[:-k]),
                    _dna.seq_to_codes(seq_b[:VERIFY_CTX]),
                    rs, rids,
                    ownership=ownership,
                )
                if not ok:
                    n_rejected += 1
                    continue
            sc.fills[i] = fill
            n_filled += 1
    if n_rejected:
        import logging

        logging.getLogger("supernova_tpu").info(
            "stackaroo: %d post-scaffold fills rejected by pair-content "
            "check (gap stays open)", n_rejected,
        )
    return n_filled
