"""How a call's output is judged against the plain reference.

Every call of the window leaves a fingerprint of its whole output, taken on
the card before the output is freed; the reference's output, put in the
program's layout, gets the same fingerprint, and a call whose fingerprint
differs is off.  The last call's output is also compared row by row.
Each number compared is exact: its limit is 0.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.kmers import lookup

SENTINEL = 0xFFFFFFFF
_M1 = 0x5851F42D4C957F2D
_M2 = 0x14057B7EF767814F
_M3 = 0x2545F4914F6CDD1D


def fingerprint(cols) -> tuple:
    """A fingerprint of integer columns, order and position included: per
    element a multiply-xorshift mix of (value, column, row), summed in two
    32-bit halves, so the sums are exact on any device."""
    sums = []
    for j, c in enumerate(cols):
        row = torch.arange(c.shape[0], device=c.device, dtype=torch.int64) * _M2
        z = (c.long() + (j + 1) * 0x9E3779B9) * _M1 + row
        z = z ^ ((z >> 31) & ((1 << 33) - 1))
        z = z * _M3
        z = z ^ ((z >> 29) & ((1 << 35) - 1))
        sums += [(z & 0xFFFFFFFF).sum(), ((z >> 32) & 0xFFFFFFFF).sum()]
    return tuple(torch.stack(sums).tolist())


# ------------------------------------------------------------ the count

def table_columns_program(table) -> list:
    """A KmerTable's columns, every row: words a, b, c, count, nbc, left and
    right masks; then n_valid as a column of one."""
    return [*table.words, table.count, table.nbc, table.left_mask, table.right_mask,
            table.n_valid.reshape(1)]


def table_columns_reference(t: dict) -> list:
    """The reference table in the program's layout: three 16-base words,
    sentinel-padded to t['rows'] rows, the other columns zero-padded."""
    n, m = int(t["hi"].shape[0]), int(t["rows"])
    dev = t["hi"].device

    def pad(x, fill):
        out = torch.full((m,), fill, dtype=torch.int64, device=dev)
        out[:n] = x
        return out

    a = t["hi"] >> 16
    b = ((t["hi"] & 0xFFFF) << 16) | (t["lo"] >> 32)
    c = t["lo"] & 0xFFFFFFFF
    return [pad(a, SENTINEL), pad(b, SENTINEL), pad(c, SENTINEL),
            *(pad(t[k], 0) for k in ("count", "nbc", "lm", "rm")),
            torch.tensor([n], dtype=torch.int64, device=dev)]


def compare_tables(prog: list, ref: list) -> dict:
    """Row-by-row comparison of a program table and the reference's, both
    as host columns in the program's layout ->
    rows_off: kmers whose row (words and the four columns) is missing from
      the other side, counted on both sides, plus rows out of ascending order;
    pad_off: padding rows not sentinel/zero, plus 1 if the row counts differ."""
    prog = [np.asarray(x, dtype=np.int64) for x in prog]
    ref = [np.asarray(x, dtype=np.int64) for x in ref]
    n_p, n_r = int(prog[7][0]), int(ref[7][0])
    m_p, m_r = prog[0].shape[0], ref[0].shape[0]
    n_p = max(0, min(n_p, m_p))
    hl = lambda c, n: (torch.from_numpy((c[0][:n] << 16) | (c[1][:n] >> 16)),
                       torch.from_numpy(((c[1][:n] & 0xFFFF) << 32) | c[2][:n]))
    phi, plo = hl(prog, n_p)
    rhi, rlo = hl(ref, n_r)
    disorder = 0
    if n_p > 1:
        d_hi, d_lo = phi[1:] - phi[:-1], plo[1:] - plo[:-1]
        disorder = int(((d_hi < 0) | ((d_hi == 0) & (d_lo <= 0))).sum())
    if disorder:
        matched = 0
    else:
        row, found = lookup(phi, plo, rhi, rlo)
        row, found = row.numpy(), found.numpy()
        same = found.copy()
        for j in range(3, 7):
            same &= prog[j][row] == ref[j][:n_r]
        matched = int(same.sum())
    pad = 0
    for j in range(7):
        fill = SENTINEL if j < 3 else 0
        pad += int((prog[j][n_p:] != fill).sum())
    return dict(rows_off=n_p + n_r - 2 * matched + disorder,
                pad_off=pad + int(m_p != m_r))


# ------------------------------------------------------------ the pather

def paths_columns_program(rp, n_reads: int) -> list:
    """ReadPaths' fields over the readset's rows (a single-block call pads
    them): the MAX_PATH edge columns, path_len, offset, first_skip,
    overflow."""
    e = rp.edges[:n_reads]
    return [*(e[:, j] for j in range(e.shape[1])), rp.path_len[:n_reads],
            rp.offset[:n_reads], rp.first_skip[:n_reads], rp.overflow[:n_reads]]


def paths_columns_reference(out: dict) -> list:
    e = out["edges"]
    return [*(e[:, j] for j in range(e.shape[1])), out["path_len"], out["offset"],
            out["first_skip"], out["overflow"]]


def compare_paths(prog: list, ref: list) -> dict:
    """reads_off: reads where any field differs (or that one side lacks)."""
    prog = [np.asarray(x, dtype=np.int64) for x in prog]
    ref = [np.asarray(x, dtype=np.int64) for x in ref]
    n = min(prog[0].shape[0], ref[0].shape[0])
    off = np.zeros(n, dtype=bool)
    for p, r in zip(prog, ref):
        off |= p[:n] != r[:n]
    return dict(reads_off=int(off.sum()) + abs(prog[0].shape[0] - ref[0].shape[0]))
