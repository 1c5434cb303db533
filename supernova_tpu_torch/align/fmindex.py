"""BWT / FM-index over graph edge sequences (port of
supernova_tpu/align/fmindex.py).

Reference: lib/tada/src/bwt.rs — Occ checkpoint table (`Occ::new/get`,
bwt.rs:34-67), `less` counts (:69), `FMIndex::backward_search` (:119),
bucketed BWT construction + merge (`compute_bwt*`, :229-317).  The
reference ships it as an experimental exact-match locator over the DBG
edge set.

  * build (device): generalized suffix array over the concatenated edge
    sequences via prefix doubling, each round one 2-key lex_argsort (kernel
    K4 on the card); edge separators use code 4 so DNA patterns (codes 0-3)
    can never match across an edge boundary.  The BWT, `less` and the Occ
    checkpoints come from one cumsum per symbol on the device (no dense
    (n, SIGMA) one-hot); the fields are numpy arrays equal to the
    reference's.
  * query (device or host): backward search batched over MANY patterns at
    once — one loop over pattern positions where every step updates all
    (lo, hi) ranges with vectorized rank (Occ) lookups: checkpoint gather
    + an in-block count over a (CHECK,) window of the BWT, the FM analogue
    of the reference's per-query loop (bwt.rs:119-138).  The host query
    (occ, backward_search, count, locate) is the reference's, copied.

The suffix array is kept whole (the reference samples it with sa_step,
bwt.rs:101-113).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.ragged import Ragged, lengths_to_offsets
from ..ops.kernels.sort import lex_argsort

SEP = 4  # edge separator code
TERM = 5  # unique terminator
SIGMA = 6  # alphabet size incl. separator + terminator
CHECK = 64  # Occ checkpoint spacing (bwt.rs uses k-spaced checkpoints)


def suffix_array(t: np.ndarray, device="cuda", info=None) -> np.ndarray:
    """Suffix array of uint8 text t (terminator must already be unique), by
    prefix doubling on `device`.  Round k sorts the suffixes by (rank of
    their first k symbols, rank of the next k); a suffix shorter than 2k has
    no second rank (the reference's -1), so the second key is shifted by +1
    and that suffix's is 0, every key in [0, 2^32) as lex_argsort takes
    them.  `info` (a dict) receives the doubling rounds.  -> int64 numpy."""
    dev = resolve_device(device)
    n = len(t)
    rank = torch.from_numpy(np.asarray(t).astype(np.int64)).to(dev)
    k, rounds = 1, 0
    while True:
        key2 = torch.zeros(n, dtype=torch.int64, device=dev)
        key2[: max(n - k, 0)] = rank[k:] + 1
        order = lex_argsort(rank, key2)
        r_o, k_o = rank[order], key2[order]
        bump = torch.ones(n, dtype=torch.int64, device=dev)
        bump[1:] = (r_o[1:] != r_o[:-1]) | (k_o[1:] != k_o[:-1])
        cum = torch.cumsum(bump, 0) - 1
        rank = torch.empty_like(cum)
        rank[order] = cum
        rounds += 1
        if int(cum[-1]) == n - 1:
            if info is not None:
                info["rounds"] = rounds
            return order.cpu().numpy()
        k *= 2


def _text(edge_seqs):
    """Edges (a list or a Ragged of base codes) -> (text, edge_starts): the
    edges in order, SEP after each, TERM last, built from one flat buffer."""
    if isinstance(edge_seqs, Ragged):
        vals = np.asarray(edge_seqs.values, np.uint8)
        offs = np.asarray(edge_seqs.offsets, np.int64)
    else:
        rows = [np.asarray(e, np.uint8) for e in edge_seqs]
        offs = lengths_to_offsets(np.array([len(r) for r in rows], np.int64))
        vals = np.concatenate(rows) if rows else np.zeros(0, np.uint8)
    n_edges = len(offs) - 1
    starts = offs + np.arange(n_edges + 1)  # one SEP after each earlier edge
    t = np.full(int(starts[-1]) + 1, SEP, np.uint8)
    t[-1] = TERM
    t[np.arange(len(vals)) + np.repeat(np.arange(n_edges), np.diff(offs))] = vals
    return t, starts


@dataclass
class FMIndex:
    bwt: np.ndarray  # (n,) uint8
    sa: np.ndarray  # (n,) int64
    less: np.ndarray  # (SIGMA,) int64  (C array)
    occ_ck: np.ndarray  # (n//CHECK + 1, SIGMA) int64 checkpoints
    edge_starts: np.ndarray  # (E+1,) int64 edge offsets in the text

    @classmethod
    def from_edges(cls, edge_seqs, device="cuda", info=None) -> "FMIndex":
        """Build from a list/Ragged of edge base-code arrays on `device`
        (`info` receives the suffix array's doubling rounds)."""
        dev = resolve_device(device)
        t, starts = _text(edge_seqs)
        n = len(t)
        sa = suffix_array(t, dev, info=info)
        tt = torch.from_numpy(t).to(dev)
        # t[-1] (the terminator) for sa == 0
        bwt = tt[(torch.from_numpy(sa).to(dev) - 1) % n]
        counts = np.bincount(t, minlength=SIGMA).astype(np.int64)
        less = np.concatenate([[0], np.cumsum(counts)[:-1]])
        nck = n // CHECK + 1
        occ_ck = np.zeros((nck, SIGMA), np.int64)
        for a in range(SIGMA):
            cum = torch.cumsum(bwt == a, 0)
            occ_ck[1:, a] = cum[CHECK - 1 :: CHECK][: nck - 1].cpu().numpy()
        return cls(bwt.cpu().numpy(), sa, less, occ_ck, starts)

    # ----------------------------------------------------------- host query
    def occ(self, r, a):
        """#occurrences of symbol a in bwt[:r] (vectorized over r)."""
        r = np.asarray(r, np.int64)
        ck = self.occ_ck[r // CHECK, a]
        base = (r // CHECK) * CHECK
        # in-block scan, vectorized: positions base..r-1
        width = int(np.max(r - base, initial=0))
        if width == 0:
            return ck
        idx = base[..., None] + np.arange(width)
        inb = idx < r[..., None]
        sym = self.bwt[np.minimum(idx, len(self.bwt) - 1)]
        return ck + np.sum((sym == a) & inb, axis=-1)

    def backward_search(self, pattern: np.ndarray):
        """(lo, hi) suffix-array range of exact matches of pattern."""
        lo, hi = np.int64(0), np.int64(len(self.bwt))
        for c in np.asarray(pattern, np.uint8)[::-1]:
            lo = self.less[c] + self.occ(np.array([lo]), c)[0]
            hi = self.less[c] + self.occ(np.array([hi]), c)[0]
            if lo >= hi:
                return np.int64(0), np.int64(0)
        return lo, hi

    def count(self, pattern) -> int:
        lo, hi = self.backward_search(pattern)
        return int(hi - lo)

    def locate(self, pattern):
        """Sorted (edge, offset) pairs of every exact occurrence."""
        lo, hi = self.backward_search(pattern)
        pos = np.sort(self.sa[lo:hi])
        edge = np.searchsorted(self.edge_starts, pos, "right") - 1
        off = pos - self.edge_starts[edge]
        return np.stack([edge, off], axis=1)

    # --------------------------------------------------------- device query
    def count_batch_device(self, patterns, lengths, device="cuda"):
        """Batched exact-match counts on `device`.

        patterns (Q, L) uint8 right-padded, lengths (Q,).  One loop over
        the L positions, right to left; each step ranks all Q live ranges
        at once.  A rank reads the (CHECK,) window of the BWT from its
        checkpoint on, its index clamped to the BWT's last row as the host
        `occ` clamps it (and as JAX clamps a gather); the window's rows at
        or past r are masked.  -> (Q,) int64 counts on `device`."""
        dev = resolve_device(device)
        n = len(self.bwt)
        pat = torch.as_tensor(np.asarray(patterns, np.uint8), device=dev)
        q, length = pat.shape
        lens = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)
        bwt = torch.from_numpy(self.bwt).to(dev)
        less = torch.from_numpy(self.less).to(dev)
        occ_ck = torch.from_numpy(self.occ_ck).to(dev)
        win_off = torch.arange(CHECK, device=dev)
        qs = torch.arange(q, device=dev)

        def rank(r, c):
            blk = r // CHECK
            idx = (blk * CHECK)[:, None] + win_off
            win = bwt[idx.clamp(max=n - 1)]
            inb = idx < r[:, None]
            return occ_ck[blk, c] + ((win == c[:, None]) & inb).sum(1)

        lo = torch.zeros(q, dtype=torch.int64, device=dev)
        hi = torch.full((q,), n, dtype=torch.int64, device=dev)
        for i in range(length):
            # pattern position len-1-i (right to left), live while i < len
            j = lens - 1 - i
            live = (j >= 0) & (hi > lo)
            c = pat[qs, j.clamp(min=0)].long()
            nlo = less[c] + rank(lo, c)
            nhi = less[c] + rank(hi, c)
            lo = torch.where(live, nlo, lo)
            hi = torch.where(live, nhi, hi)
        return (hi - lo).clamp(min=0)
