"""The multichip dry run's scaffold-join and phasing rounds on a mesh
(counterparts of __graft_entry__.py's _scaffold_join_round and
_phase_round): small fixed graphs whose link triples and phasing votes are
accumulated over the mesh's shards (sharded_scaffold, sharded_phase), then
fed to the host's Star join and Flipper phasing."""
from __future__ import annotations

import numpy as np

from ..asm import lines as alines
from ..asm import phasing as aph
from ..asm import star as astar
from ..asm import supergraph as asgx
from ..asm.links import incidence_from_sets, neighbors_ranked
from ..core import dna
from ..core.kmer_codec import K
from ..core.ragged import Ragged
from ..dbg.graph import BaseGraph
from ..out import pseudohap as oph
from .sharded_phase import sharded_vote_matrix, split_votes
from .sharded_scaffold import sharded_bc_links, split_incidence


def scaffold_join_round(mesh):
    """Two dead-ended lines with junction-shaped shared barcodes: the link
    triples are computed on the mesh (sharded_bc_links), then Star's
    advantage scoring joins them with a {-2} gap edge (asm/star.py;
    reference Star.cc:8-27 + Scaffold.cc barcode-link accumulation).
    Returns (n_lines_before, n_lines_after)."""
    rng = np.random.default_rng(7)
    ll = 10_000
    ea = rng.integers(0, 4, ll).astype(np.uint8)
    eb = rng.integers(0, 4, ll).astype(np.uint8)
    bgs = BaseGraph(
        edges=Ragged.from_rows([ea, eb, dna.revcomp(eb), dna.revcomp(ea)], dtype=np.uint8),
        inv=np.array([3, 2, 1, 0], np.int32),
        from_v=np.array([0, 2, 4, 6], np.int32),
        to_v=np.array([1, 3, 5, 7], np.int32),
        n_vertices=8,
        is_circle=np.zeros(4, bool),
    )
    ds = asgx.SuperGraph(
        epaths=Ragged.from_rows([np.array([e], np.int64) for e in range(4)], dtype=np.int64),
        dinv=np.array([3, 2, 1, 0], np.int64),
        from_v=np.array([0, 2, 4, 6], np.int32),
        to_v=np.array([1, 3, 5, 7], np.int32),
        n_vertices=8,
        bg=bgs,
    )
    lines_s = alines.find_lines(ds)
    n_before = lines_s.n_lines
    line_of_edge = {int(d): li for li, ln in enumerate(lines_s.lines) for d in ln.edges()}
    a, b = line_of_edge[0], line_of_edge[1]
    llens = lines_s.lengths(ds)
    linv = lines_s.linv
    # junction-shaped barcode evidence: shared barcodes cluster at A's right
    # end and B's left start (mirrored on the rc lines)
    lbp = {li: [] for li in range(n_before)}
    for bc in range(1, 31):
        for j in range(5):
            lbp[a].append((bc, ll - 1_000 + 200 * j))
            lbp[b].append((bc, 200 * j))
    for li in (a, b):
        lbp[int(linv[li])] = [(bc, int(llens[li]) - p) for bc, p in lbp[li]]
    bsets = [np.unique([bc for bc, _ in lbp[li]]).astype(np.int64) if lbp[li]
             else np.zeros(0, np.int64) for li in range(n_before)]
    bcv, item = incidence_from_sets(bsets)
    bc_sh, it_sh = split_incidence(bcv, item, mesh.size)
    i1, i2, sh = sharded_bc_links(mesh, bc_sh, it_sh, cap=16, out_cap=2048, min_shared=2)
    lhood = neighbors_ranked(i1, i2, sh, max_view=10)
    rdead = astar.right_dead_ends(lines_s, ds)
    joins = astar.star_joins(range(n_before), llens, linv, lbp, lhood, rdead, min_star=1_000)
    assert joins, "mesh-linked star round produced no join"
    d2 = astar.insert_star_gaps(ds, lines_s, joins, {(j[0], j[1]): 500 for j in joins})
    d2.validate()
    return n_before, alines.find_lines(d2).n_lines


def phase_round(mesh):
    """A Flipper phasing round with molecule votes accumulated on the mesh
    (sharded_vote_matrix; reference Flipper.cc:3-29,36-75), then pseudohap
    emission: the mesh's support matrix must phase the line as the host's
    does and spell the same pseudohap string.  Returns (n_bubbles,
    phased_frac)."""
    rng = np.random.default_rng(11)
    # a 2-bubble line: S0 -(A1|B1)- S1 -(A2|B2)- S2, K-1 overlaps so the
    # gap-aware walker can spell it; rc partners mirror the chain
    s = [rng.integers(0, 4, 300).astype(np.uint8) for _ in range(3)]
    arms = []
    for i in range(2):
        a = np.concatenate([s[i][-(K - 1):], rng.integers(0, 4, 200).astype(np.uint8),
                            s[i + 1][: K - 1]])
        b = np.concatenate([s[i][-(K - 1):], rng.integers(0, 4, 200).astype(np.uint8),
                            s[i + 1][: K - 1]])
        arms.append((a, b))
    fwd = [s[0], arms[0][0], arms[0][1], s[1], arms[1][0], arms[1][1], s[2]]
    seqs = fwd + [dna.revcomp(x) for x in fwd[::-1]]
    ne = len(seqs)
    inv = np.array([ne - 1 - i for i in range(ne)], np.int32)
    fv = np.array([0, 1, 1, 2, 3, 3, 4, 6, 7, 7, 8, 9, 9, 10], np.int32)
    tv = np.array([1, 2, 2, 3, 4, 4, 5, 7, 8, 8, 9, 10, 10, 11], np.int32)
    bg = BaseGraph(edges=Ragged.from_rows(seqs, dtype=np.uint8), inv=inv, from_v=fv,
                   to_v=tv, n_vertices=12, is_circle=np.zeros(ne, bool))
    d = asgx.SuperGraph(
        epaths=Ragged.from_rows([np.array([e], np.int64) for e in range(ne)], dtype=np.int64),
        dinv=inv.astype(np.int64), from_v=fv.copy(), to_v=tv.copy(), n_vertices=12, bg=bg,
    )
    d.validate()
    lines = alines.find_lines(d)
    li = next(i for i, ln in enumerate(lines.lines) if 0 in [int(x) for x in ln.edges()])
    line = lines.lines[li]
    bub_cells = [el for el in line.elements if len(el) == 2]
    assert len(bub_cells) == 2
    truth = [1, -1]
    n_mols = 30
    counts_host: dict = {}
    re_rows, rb_rows = [], []
    for m in range(n_mols):
        hap = 1 if m % 2 == 0 else -1
        for bi, el in enumerate(bub_cells):
            v = truth[bi] * hap
            arm_edge = int(el.paths[0 if v > 0 else 1][0])
            counts_host.setdefault(arm_edge, {})[m] = 3
            re_rows.extend([arm_edge] * 3)
            rb_rows.extend([m] * 3)
    # host reference phasing + support matrix
    ph_host = aph.phase_line(line, counts_host, dinv=d.dinv)
    bubbles = [aph.Bubble(i, [el.paths[0].copy(), el.paths[1].copy()])
               for i, el in enumerate(line.elements) if len(el) == 2]
    s_host, bcs_host = aph._support_matrix(bubbles, counts_host)
    # mesh accumulation: votes data-parallel, summed into (B, M)
    edge_bubble = np.full(ne, -1, np.int32)
    edge_sign = np.zeros(ne, np.int32)
    for bi, el in enumerate(bub_cells):
        edge_bubble[int(el.paths[0][0])] = bi
        edge_sign[int(el.paths[0][0])] = 1
        edge_bubble[int(el.paths[1][0])] = bi
        edge_sign[int(el.paths[1][0])] = -1
    re_sh, rb_sh = split_votes(np.asarray(re_rows, np.int32), np.asarray(rb_rows, np.int32),
                               mesh.size)
    s_mesh = sharded_vote_matrix(mesh, edge_bubble, edge_sign, re_sh, rb_sh, len(bub_cells),
                                 n_mols)
    assert np.array_equal(s_mesh[:, np.asarray(bcs_host)], s_host)
    # phase from the mesh matrix and emit pseudohap both ways
    counts_mesh: dict = {}
    for bi, el in enumerate(bub_cells):
        for m in range(n_mols):
            v = int(s_mesh[bi, m])
            if v > 0:
                counts_mesh.setdefault(int(el.paths[0][0]), {})[m] = v
            elif v < 0:
                counts_mesh.setdefault(int(el.paths[1][0]), {})[m] = -v
    ph_mesh = aph.phase_line(line, counts_mesh, dinv=d.dinv)
    assert np.array_equal(ph_host.x, ph_mesh.x) and np.any(ph_host.x != 0)
    seq_h = oph.line_sequence(d, line, oph._phase_choices(line, ph_host, 0))
    seq_m = oph.line_sequence(d, line, oph._phase_choices(line, ph_mesh, 0))
    assert seq_h == seq_m and len(seq_h) > 1000
    return len(bub_cells), float((ph_host.x != 0).mean())
