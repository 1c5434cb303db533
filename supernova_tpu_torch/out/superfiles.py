"""SuperFiles: the final/a.sup* checkpoint family.

The port's own copy of supernova_tpu/out/superfiles.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference behavior (10X/SuperFiles.cc:96-191, SURVEY.md §8): after CP's last
stage, write the final supergraph + per-line evidence as the `final/a.sup*`
file set that MakeFasta and downstream tools consume: sup/inv, lines, llens,
lbpx (barcode positions), lcov, ebc (per-edge barcode sets), fastb (edge
sequences), dpaths(+counts).

Here each file is an .npz with flat arrays (the feudal BINWRITE analogue):
  final/a.sup.npz         epaths CSR + dinv + from_v/to_v (the graph D)
  final/a.sup.lines.npz   4-level ragged lines (values + 3 offset levels)
  final/a.sup.llens.npz   per-line base lengths
  final/a.sup.lbpx.npz    (line, barcode, pos) barcode-position triples
  final/a.sup.lcov.npz    per-line barcode coverage
  final/a.sup.ebc.npz     per-D-edge barcode sets (CSR)
  final/a.sup.fastb.npz   per-D-edge base sequences (CSR; gaps empty)
  final/a.dpaths.npz      read paths on D + per-edge read counts
  final/a.phasing.npz     per-line bubble phasing vectors

The 4-level lines encoding mirrors the reference's
vec<vec<vec<vec<int>>>> (line -> cell -> path -> edge): `values` holds edge
ids; `po` delimits paths in values; `eo` delimits cells in po; `lo`
delimits lines in eo.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..core.ragged import Ragged


def encode_lines(lines) -> dict:
    values: List[np.ndarray] = []
    po = [0]  # path boundaries (in edges)
    eo = [0]  # cell boundaries (in paths)
    lo = [0]  # line boundaries (in cells)
    nv = 0
    for ln in lines.lines:
        for cell in ln.elements:
            for p in cell.paths:
                values.append(np.asarray(p, np.int64))
                nv += len(p)
                po.append(nv)
            eo.append(len(po) - 1)
        lo.append(len(eo) - 1)
    return dict(
        values=np.concatenate(values) if values else np.zeros(0, np.int64),
        po=np.asarray(po, np.int64),
        eo=np.asarray(eo, np.int64),
        lo=np.asarray(lo, np.int64),
        linv=np.asarray(lines.linv, np.int64),
        line_of_edge=np.asarray(lines.line_of_edge, np.int64),
    )


def decode_lines(z):
    from ..asm.lines import Cell, Line, Lines

    values, po, eo, lo = z["values"], z["po"], z["eo"], z["lo"]
    out = []
    for li in range(len(lo) - 1):
        cells = []
        for ci in range(int(lo[li]), int(lo[li + 1])):
            paths = [
                values[int(po[pi]) : int(po[pi + 1])].copy()
                for pi in range(int(eo[ci]), int(eo[ci + 1]))
            ]
            cells.append(Cell(paths))
        out.append(Line(cells))
    return Lines(
        lines=out,
        line_of_edge=z["line_of_edge"].copy(),
        linv=z["linv"].copy(),
    )


def write_super_files(
    outdir: str | Path,
    D,
    lines,
    phasings: Optional[Dict[int, np.ndarray]] = None,
    dpaths: Optional[np.ndarray] = None,
    dlen: Optional[np.ndarray] = None,
    ebc: Optional[Ragged] = None,
    llens: Optional[np.ndarray] = None,
    lbpx: Optional[List[tuple]] = None,
    lcov: Optional[np.ndarray] = None,
) -> Path:
    final = Path(outdir) / "final"
    final.mkdir(parents=True, exist_ok=True)

    np.savez_compressed(
        final / "a.sup.npz",
        epaths_values=D.epaths.values,
        epaths_offsets=D.epaths.offsets,
        dinv=np.asarray(D.dinv, np.int64),
        from_v=np.asarray(D.from_v, np.int64),
        to_v=np.asarray(D.to_v, np.int64),
        n_vertices=np.int64(D.n_vertices),
    )
    np.savez_compressed(final / "a.sup.lines.npz", **encode_lines(lines))

    if llens is None:
        llens = lines.lengths(D)
    np.savez_compressed(final / "a.sup.llens.npz", llens=np.asarray(llens, np.int64))

    if lbpx:
        trip = np.asarray(
            [(int(li), int(bc), int(p)) for li, bc, p in lbpx], np.int64
        ).reshape(-1, 3)
    else:
        trip = np.zeros((0, 3), np.int64)
    np.savez_compressed(
        final / "a.sup.lbpx.npz",
        line=trip[:, 0], bc=trip[:, 1], pos=trip[:, 2],
    )
    if lcov is None:
        lcov = np.zeros(lines.n_lines, np.float64)
    np.savez_compressed(final / "a.sup.lcov.npz", lcov=np.asarray(lcov, np.float64))

    if ebc is not None:
        np.savez_compressed(
            final / "a.sup.ebc.npz",
            values=ebc.values, offsets=ebc.offsets,
        )

    # edge sequences (fastb analogue): gap edges spell as empty rows (their
    # representation lives in a.sup's epaths)
    seqs = []
    gm = D.gap_mask()
    for d in range(D.n_edges):
        seqs.append(
            np.zeros(0, np.uint8) if gm[d] else D.edge_bases(d).astype(np.uint8)
        )
    fb = Ragged.from_rows(seqs, dtype=np.uint8) if seqs else Ragged(
        np.zeros(0, np.uint8), np.zeros(1, np.int64)
    )
    np.savez_compressed(
        final / "a.sup.fastb.npz", values=fb.values, offsets=fb.offsets
    )

    if dpaths is not None and dlen is not None:
        from ..asm.place import dpath_counts

        np.savez_compressed(
            final / "a.dpaths.npz",
            dpaths=dpaths, dlen=dlen, counts=dpath_counts(D, dpaths, dlen),
        )

    if phasings:
        # per line: bubble element indices + x vector (same ragged shape),
        # phase-block [start,end) pairs, score.  Arms are derivable from the
        # line's cells, so this fully reconstructs LinePhasing.
        keys = np.asarray(sorted(phasings), np.int64)
        ei_rows, x_rows, blk_rows, scores = [], [], [], []
        for k in keys:
            p = phasings[int(k)]
            ei_rows.append(
                np.asarray([b.element_idx for b in p.bubbles], np.int64)
            )
            x_rows.append(np.asarray(p.x, np.int64))
            blk_rows.append(np.asarray(p.blocks, np.int64).reshape(-1))
            scores.append(float(p.score))
        ei = Ragged.from_rows(ei_rows, dtype=np.int64)
        xv = Ragged.from_rows(x_rows, dtype=np.int64)
        blk = Ragged.from_rows(blk_rows, dtype=np.int64)
        np.savez_compressed(
            final / "a.phasing.npz",
            lines=keys,
            ei_values=ei.values, ei_offsets=ei.offsets,
            x_values=xv.values, x_offsets=xv.offsets,
            blk_values=blk.values, blk_offsets=blk.offsets,
            scores=np.asarray(scores, np.float64),
        )
    return final


def load_super_files(outdir: str | Path, bg) -> dict:
    """Load the final/a.sup* family back into live objects (START=x
    re-entry analogue for post-CP tools)."""
    from ..asm.supergraph import SuperGraph

    final = Path(outdir) / "final"
    z = np.load(final / "a.sup.npz")
    D = SuperGraph(
        epaths=Ragged(z["epaths_values"], z["epaths_offsets"]),
        dinv=z["dinv"],
        from_v=z["from_v"],
        to_v=z["to_v"],
        n_vertices=int(z["n_vertices"]),
        bg=bg,
    )
    lines = decode_lines(np.load(final / "a.sup.lines.npz"))
    out = dict(D=D, lines=lines)
    out["llens"] = np.load(final / "a.sup.llens.npz")["llens"]
    lz = np.load(final / "a.sup.lbpx.npz")
    out["lbpx"] = list(zip(lz["line"], lz["bc"], lz["pos"]))
    out["lcov"] = np.load(final / "a.sup.lcov.npz")["lcov"]
    p = final / "a.phasing.npz"
    if p.exists():
        from ..asm.phasing import Bubble, LinePhasing

        pz = np.load(p)
        ei = Ragged(pz["ei_values"], pz["ei_offsets"])
        xv = Ragged(pz["x_values"], pz["x_offsets"])
        blk = Ragged(pz["blk_values"], pz["blk_offsets"])
        phasings = {}
        for i, k in enumerate(pz["lines"]):
            li = int(k)
            cells = lines.lines[li].elements
            bubbles = [
                Bubble(int(e), list(cells[int(e)].paths))
                for e in ei.row(i)
            ]
            blocks = [
                (int(a), int(b))
                for a, b in blk.row(i).reshape(-1, 2)
            ]
            phasings[li] = LinePhasing(
                bubbles, xv.row(i).copy(), blocks, float(pz["scores"][i])
            )
        out["phasings"] = phasings
    dp = final / "a.dpaths.npz"
    if dp.exists():
        dz = np.load(dp)
        out["dpaths"], out["dlen"], out["counts"] = (
            dz["dpaths"], dz["dlen"], dz["counts"]
        )
    e = final / "a.sup.ebc.npz"
    if e.exists():
        ez = np.load(e)
        out["ebc"] = Ragged(ez["values"], ez["offsets"])
    return out
