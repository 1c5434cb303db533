"""Batched affine-gap alignment scores on torch tensors: the port of
supernova_tpu/ops/alignment.py (the SmithWatAffine analogue that scores
bubble arm against arm for the het estimate, asm/het.py).

The reference runs the DP as a jitted, vmapped lax.scan over the rows of
the (LA+1, LB+1) matrix with a nested scan along each row for the
insertions.  Here one Python loop walks the LA rows with the whole batch's
(B, LB+1) row as the state, on the tensors' device and with no host
synchronisation inside the loop.  The insertion scan along a row,

    I[j] = min(I[j-1] + ext, interim[j-1] + open + ext),  I[0] = BIG,

is a prefix minimum: I[j] = ext*j + cummin_k<=j(min(BIG, interim[k-1] +
open + ext - ext*k)), computed in int64 (the reference's int32 values stay
below BIG + ~2e4, so the numbers are the same, with no wrap) and narrowed
to int32.  The reference's quirks are kept: row 0's insertion costs are
masked to j <= n_b, padded columns cost `mis`, rows past n_a keep the
previous row, and the answer is best[n_b].

Scoring (penalties, lower = closer): mismatch MIS, gap open OPEN, gap
extend EXT, as the reference's.  brute_affine_np is the reference's
O(LA*LB) oracle, copied for the tests.
"""
from __future__ import annotations

import time

import numpy as np
import torch

MIS = 3
OPEN = 12
EXT = 1
BIG = np.int32(10**9 // 2)


def affine_align_score(a, b, la, lb, mis: int = MIS, open_: int = OPEN, ext: int = EXT):
    """Global affine alignment penalty per pair on the tensors' device.

    a (B, LA), b (B, LB): integer codes padded with -1; la, lb (B,): true
    lengths -> (B,) int32."""
    dev = a.device
    big = int(BIG)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    la = la.to(dev, torch.int64)
    lb = lb.to(dev, torch.int64)
    n_pairs, n_rows = a.shape
    j = torch.arange(b.shape[1] + 1, dtype=torch.int64, device=dev)
    bmask = j[None, 1:] <= lb[:, None]  # valid b positions (1-based columns)
    # row 0: gaps in a
    m0 = torch.where(j == 0, 0, big)
    ins0 = torch.where(j == 0, big, open_ + ext * (j - 1) + ext)
    ins0 = torch.where(j[None, :] <= lb[:, None], ins0[None, :], big)
    dele = torch.full((n_pairs, j.shape[0]), big, dtype=torch.int64, device=dev)
    best = torch.minimum(m0[None, :], torch.minimum(ins0, dele))
    first = torch.full((n_pairs, 1), big, dtype=torch.int64, device=dev)
    # interim[k-1] + open + ext - ext*k for k = 1..LB, and ext*j for j = 1..LB
    ramp_in = (open_ + ext) - ext * j[1:]
    ramp_out = ext * j[1:]
    for i in range(n_rows):
        sub = torch.where((a[:, i : i + 1] == b) & bmask, 0, mis)
        m_row = torch.cat([first, best[:, :-1] + sub], dim=1)  # M[i,j] from best[i-1,j-1]
        dele_row = torch.minimum(dele + ext, best + open_ + ext)  # gap in b
        interim = torch.minimum(m_row, dele_row)
        ins = torch.cummin((interim[:, :-1] + ramp_in).clamp(max=big), dim=1).values + ramp_out
        best_row = torch.minimum(interim, torch.cat([first, ins], dim=1))
        # row i is only meaningful while i < n_a; keep the last valid row
        keep = (la > i)[:, None]
        best = torch.where(keep, best_row, best)
        dele = torch.where(keep, dele_row, dele)
    return best.gather(1, lb[:, None])[:, 0].to(torch.int32)


def align_pairs(seq_pairs, device, mis=MIS, open_=OPEN, ext=EXT, info: dict | None = None):
    """List of (codes_a, codes_b) -> (B,) int32 penalties (numpy), the DP
    on `device`; padded as the reference's align_pairs_np.  `info`, when
    given, receives the pairs, the padded (LA, LB) and the DP's seconds
    (host clock, ending when the result is back on the host)."""
    if not seq_pairs:
        return np.zeros(0, np.int32)
    la = np.array([len(a) for a, _ in seq_pairs], np.int32)
    lb = np.array([len(b) for _, b in seq_pairs], np.int32)
    LA, LB = int(la.max()), int(lb.max())
    A = np.full((len(seq_pairs), LA), -1, np.int32)
    B = np.full((len(seq_pairs), LB), -1, np.int32)
    for i, (a, b) in enumerate(seq_pairs):
        A[i, : len(a)] = a
        B[i, : len(b)] = b
    t = lambda x: torch.from_numpy(x).to(device)
    t0 = time.perf_counter()
    pen = affine_align_score(t(A), t(B), t(la), t(lb), mis=mis, open_=open_, ext=ext)
    out = pen.cpu().numpy()
    if info is not None:
        info.update(pairs=len(seq_pairs), shape=(LA, LB), seconds=time.perf_counter() - t0)
    return out


def brute_affine_np(a, b, mis=MIS, open_=OPEN, ext=EXT):
    """O(LA*LB) reference implementation for tests."""
    la, lb = len(a), len(b)
    INF = 10**9 // 2
    M = np.full((la + 1, lb + 1), INF, np.int64)
    I = np.full((la + 1, lb + 1), INF, np.int64)  # gap in a (move along b)
    D = np.full((la + 1, lb + 1), INF, np.int64)  # gap in b
    M[0, 0] = 0
    for j in range(1, lb + 1):
        I[0, j] = open_ + ext * j
    for i in range(1, la + 1):
        D[i, 0] = open_ + ext * i
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            sub = 0 if a[i - 1] == b[j - 1] else mis
            M[i, j] = min(M[i - 1, j - 1], I[i - 1, j - 1], D[i - 1, j - 1]) + sub
            I[i, j] = min(
                M[i, j - 1] + open_ + ext,
                I[i, j - 1] + ext,
                D[i, j - 1] + open_ + ext,
            )
            D[i, j] = min(
                M[i - 1, j] + open_ + ext,
                D[i - 1, j] + ext,
                I[i - 1, j] + open_ + ext,
            )
    return int(min(M[la, lb], I[la, lb], D[la, lb]))
