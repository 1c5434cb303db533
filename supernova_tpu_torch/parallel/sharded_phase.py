"""Mesh-parallel Flipper support accumulation (port of
supernova_tpu/parallel/sharded_phase.py): molecule votes summed over the
mesh.

SURVEY §5.8: phasing consumes a bubble x molecule support matrix
s[b, m] = reads(arm0) - reads(arm1) (Flipper.cc:36-75 BandedMatrix).  The
reads live data-parallel across the mesh after pathing, so each shard
scatter-adds its votes (a read placed on an arm edge -> +/-1 into its
(bubble, molecule) cell) into a local dense matrix, and one tensor sum over
the mesh (Mesh.tensor_sum, the reference's psum) yields the full matrix.
The flip search itself stays host-side - a line's matrix is small while
the votes are read-scale.

The scatter is index_add_ on the flattened matrix: on integers its result
does not depend on the order of duplicate indices, on the CPU or the card.
Tested equal to the reference and to asm/phasing._support_matrix on the
CPU (tests/test_torch_sharded_phase.py).
"""
from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def _votes_local(re, rb, edge_bubble, edge_sign, n_bubbles: int, n_mols: int):
    """One shard's (read_edge, read_bc) rows -> its (B, M) int32 vote
    matrix (the reference's body before its psum).  Rows with re < 0, no
    bubble, rb < 0 or rb >= n_mols add nothing; so do rows whose bubble is
    >= n_bubbles, whose scatter JAX drops.  re is clamped before the gather,
    as JAX clamps it."""
    if edge_bubble.shape[0] == 0:
        bub = torch.full_like(re, -1)
        sgn = torch.zeros_like(re)
    else:
        e = re.clamp(0, edge_bubble.shape[0] - 1)
        bub, sgn = edge_bubble[e], edge_sign[e]
    valid = (re >= 0) & (bub >= 0) & (bub < n_bubbles) & (rb >= 0) & (rb < n_mols)
    idx = torch.where(valid, bub * n_mols + rb, 0)
    v = torch.where(valid, sgn, 0).to(I32)
    mat = torch.zeros(n_bubbles * n_mols, dtype=I32, device=re.device)
    return mat.index_add_(0, idx, v).view(n_bubbles, n_mols)


def sharded_vote_matrix(
    mesh, edge_bubble, edge_sign, read_edge_sh, read_bc_sh,
    n_bubbles: int, n_mols: int,
):
    """Accumulate the phasing support matrix over the mesh's shards (in a
    fleet, every process's: each scatters its own shards' rows and gets
    the whole sum).

    edge_bubble: (E,) int32, bubble index of each D-edge or -1;
    edge_sign: (E,) int32, +1 for arm0 edges, -1 for arm1, 0 otherwise;
    read_edge_sh/read_bc_sh: (n_dev, rows) shards of per-read vote rows
    (-1 padded; one row per read placed on an arm edge; split_votes), all
    of the mesh's on every process.
    -> (n_bubbles, n_mols) numpy int32, the sum over every shard."""
    eb_np = np.asarray(edge_bubble, np.int64)
    es_np = np.asarray(edge_sign, np.int64)
    mats, on = [], {}
    for i, d in enumerate(mesh.devices):
        if d not in on:
            on[d] = (torch.from_numpy(eb_np).to(d), torch.from_numpy(es_np).to(d))
        g = mesh.global_index(i)
        re = torch.from_numpy(np.asarray(read_edge_sh[g], np.int64)).to(d)
        rb = torch.from_numpy(np.asarray(read_bc_sh[g], np.int64)).to(d)
        mats.append(_votes_local(re, rb, *on[d], n_bubbles, n_mols))
    return mesh.tensor_sum(mats)[0].cpu().numpy()


def split_votes(read_edge, read_bc, n_dev: int, bucket: int = 256):
    """Host prep: flat vote rows -> (n_dev, rows) -1-padded shards."""
    n = len(read_edge)
    per = -(-max(n, 1) // n_dev)
    per = -(-per // bucket) * bucket
    re_sh = np.full((n_dev, per), -1, np.int32)
    rb_sh = np.full((n_dev, per), -1, np.int32)
    for d in range(n_dev):
        lo, hi = d * per, min((d + 1) * per, n)
        if hi > lo:
            re_sh[d, : hi - lo] = read_edge[lo:hi]
            rb_sh[d, : hi - lo] = read_bc[lo:hi]
    return re_sh, rb_sh
