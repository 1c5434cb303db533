"""Assembly-vs-reference evaluation — the astats analogue.

The port's own copy of supernova_tpu/asm/evaluate.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference: 10X/astats/ GenomeAlign (K=80 perfect-kmer alignment to ref),
Misassembly, AlignFin/perfect-stretch N50 vs finished sequence
(AssemblyStats.cc:58-751).  Used with simulation truth haplotypes here:
contigs are anchored to the reference by exact 80-mers, placed on the
majority diagonal, and compared base-by-base; perfect-stretch lengths,
misassembly candidates, and covered fraction come out.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..core import dna
from ..stats.logger import n50

ANCHOR_K = 80  # astats/GenomeAlign.cc perfect-kmer K


@dataclass
class ContigEval:
    length: int
    anchored: bool
    identity: float  # fraction matching on the best diagonal
    stretches: List[int] = field(default_factory=list)  # perfect stretch lens
    misassembled: bool = False


def _ref_index(refs: List[np.ndarray], k: int = ANCHOR_K):
    idx: Dict[bytes, List[Tuple[int, int]]] = defaultdict(list)
    for ri, ref in enumerate(refs):
        rb = np.asarray(ref, dtype=np.uint8).tobytes()
        for p in range(0, len(rb) - k + 1, 7):  # stride keeps the dict small
            idx[rb[p : p + k]].append((ri, p))
    return idx


def evaluate_contig(contig: np.ndarray, refs, idx, k: int = ANCHOR_K) -> ContigEval:
    cb = np.asarray(contig, dtype=np.uint8)
    ev = ContigEval(length=len(cb), anchored=False, identity=0.0)
    if len(cb) < k:
        return ev
    cbb = cb.tobytes()
    votes: Counter = Counter()
    for p in range(0, len(cb) - k + 1, 13):
        for ri, rp in idx.get(cbb[p : p + k], ()):
            votes[(ri, rp - p)] += 1
    if not votes:
        return ev
    (ri, diag), nvotes = votes.most_common(1)[0]
    ref = np.asarray(refs[ri], dtype=np.uint8)
    lo = max(0, -diag)
    hi = min(len(cb), len(ref) - diag)
    if hi <= lo:
        return ev
    ev.anchored = True
    eq = cb[lo:hi] == ref[lo + diag : hi + diag]
    ev.identity = float(eq.mean())
    # perfect stretches
    run = 0
    for m in eq:
        if m:
            run += 1
        else:
            if run:
                ev.stretches.append(run)
            run = 0
    if run:
        ev.stretches.append(run)
    # misassembly: a second strong diagonal on the SAME reference strand
    # (a diploid contig legitimately anchors to both haplotypes, so votes
    # for other refs don't count against it).  The second diagonal must be
    # VERIFIED by direct comparison: the strided reference index samples
    # only every 7th ref position, so a contig lying entirely inside a
    # two-copy repeat sees copy 1 at some windows and copy 2 at others —
    # two "diagonals" with the primary matching perfectly throughout.  A
    # real misassembly requires the primary diagonal to STOP matching
    # where the second one wins.
    same_ref = [
        (d, c) for (r2, d), c in votes.items() if r2 == ri and d != diag
    ]
    if same_ref:
        # >=3 sampled windows on the second diagonal suffice: the direct
        # verification below carries the precision (repeat copies pass it),
        # and a 0.5*nvotes gate would miss short chimeric segments on long
        # contigs (e.g. a 14kb wrong arm on a 57kb contig)
        d2, second = max(same_ref, key=lambda t: (t[1], -abs(t[0] - diag)))
        if second >= 3:
            primary_fails = False
            for p in range(0, len(cb) - k + 1, 13):
                if (ri, d2) not in [
                    (r3, rp - p) for r3, rp in idx.get(cbb[p : p + k], ())
                ]:
                    continue
                q = p + diag
                if (
                    q < 0
                    or q + k > len(ref)
                    or not np.array_equal(cb[p : p + k], ref[q : q + k])
                ):
                    primary_fails = True
                    break
            if primary_fails:
                ev.misassembled = True
    if ev.identity < 0.8:
        ev.misassembled = True
    return ev


_POOL_STATE: dict = {}


def _pool_eval(args):
    lo, hi = args
    refs, idx, contigs = (
        _POOL_STATE["refs"], _POOL_STATE["idx"], _POOL_STATE["contigs"]
    )
    return [evaluate_contig(c, refs, idx) for c in contigs[lo:hi]]


def _map_contigs(contigs, refs, idx, min_parallel: int = 64):
    """Per-contig evaluation is independent; at rung scale (1000s of
    contigs, a multi-GB kmer index) fork-based workers inherit the index
    copy-on-write and cut the 100 Mb evaluate wall ~4x.  Serial fallback
    for small inputs or any pool failure."""
    import multiprocessing as mp
    import os

    n = len(contigs)
    if n < min_parallel or os.environ.get("SN_EVAL_SERIAL"):
        return [evaluate_contig(c, refs, idx) for c in contigs]
    try:
        workers = min(4, os.cpu_count() or 1)
        _POOL_STATE.update(refs=refs, idx=idx, contigs=contigs)
        step = -(-n // (workers * 4))
        spans = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
        ctx = mp.get_context("fork")
        with ctx.Pool(workers) as pool:
            # Forking a JAX-initialized (multithreaded) parent can deadlock
            # a child on locks held at fork time; a hang isn't an exception,
            # so bound the wait and fall back to serial (ADVICE r4 #4).
            # Budget: generous per-contig allowance, never less than 10 min.
            budget = max(600.0, 0.5 * n)
            chunks = pool.map_async(_pool_eval, spans).get(timeout=budget)
        return [e for ch in chunks for e in ch]
    except mp.TimeoutError:
        return [evaluate_contig(c, refs, idx) for c in contigs]
    except Exception:
        return [evaluate_contig(c, refs, idx) for c in contigs]
    finally:
        _POOL_STATE.clear()


def evaluate_assembly(contigs: List[np.ndarray], haplotypes) -> Dict[str, float]:
    """contigs: base-code arrays; haplotypes: truth code arrays (both
    strands are derived automatically).  -> astats-style metric dict."""
    refs = []
    for h in haplotypes:
        refs.append(np.asarray(h, dtype=np.uint8))
        refs.append(dna.revcomp(h).astype(np.uint8))
    idx = _ref_index(refs)
    evs = _map_contigs(contigs, refs, idx)
    stretches = [s for e in evs for s in e.stretches]
    total = sum(e.length for e in evs)
    anchored = sum(e.length for e in evs if e.anchored)
    return {
        "n_contigs": len(evs),
        "total_bases": total,
        "anchored_frac": anchored / total if total else 0.0,
        "perfect_stretch_N50": n50(stretches),
        "mean_identity": (
            float(np.mean([e.identity for e in evs if e.anchored]))
            if any(e.anchored for e in evs)
            else 0.0
        ),
        "misassemblies": sum(1 for e in evs if e.misassembled),
    }
