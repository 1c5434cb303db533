"""Histogram JSONs + plots — WriteHistToJson / supernova/plot.py analogues.

The port's own copy of supernova_tpu/stats/histograms.py, kept equal to it
by tests/test_torch_hostcopies.py: the port imports nothing of the JAX
package.

The reference emits kmer-spectrum (BuildReadQGraph48.cc:199-216), molecule
length (CP.cc:968-972), and contig/edge/phase_block/scaffold/reads_per_
barcode histograms (CP.cc:1916-1922) as JSON, rendered by
tenkit/lib/python/tenkit/supernova/plot.py.  Same schema here:
{"description": ..., "bins": [...], "counts": [...]}.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Sequence

import numpy as np


def write_hist_json(
    path: str | Path, description: str, bins: Sequence, counts: Sequence
):
    Path(path).write_text(
        json.dumps(
            {
                "description": description,
                "bins": list(map(int, bins)),
                "counts": list(map(int, counts)),
            }
        )
        + "\n"
    )


def kmer_spectrum(table, max_count: int = 256) -> Dict[str, np.ndarray]:
    """Multiplicity spectrum of the (unfiltered) kmer counts."""
    n = int(table.n_valid)
    counts = np.asarray(table.count)[:n]
    cl = np.minimum(counts, max_count)
    hist = np.bincount(cl, minlength=max_count + 1)
    return {"bins": np.arange(max_count + 1), "counts": hist}


def length_histogram(lengths, bin_width: int = 1000, max_bins: int = 200):
    lengths = np.asarray(lengths)
    if lengths.size == 0:
        return {"bins": np.zeros(0, int), "counts": np.zeros(0, int)}
    b = np.minimum(lengths // bin_width, max_bins - 1).astype(int)
    hist = np.bincount(b, minlength=max_bins)
    return {"bins": np.arange(max_bins) * bin_width, "counts": hist}


def reads_per_barcode_histogram(rs):
    rpb = np.diff(rs.bci)[1:]
    rpb = rpb[rpb > 0]
    if rpb.size == 0:
        return {"bins": np.zeros(0, int), "counts": np.zeros(0, int)}
    mx = min(int(rpb.max()), 10_000)
    hist = np.bincount(np.minimum(rpb, mx).astype(int), minlength=mx + 1)
    return {"bins": np.arange(mx + 1), "counts": hist}


def molecule_length_histogram(rs, bg, paths_edges, path_len, offset):
    """lw molecule-length estimate: per (barcode), span of read placements on
    each edge chain — simplified to per-barcode read span per first edge
    (the reference fits molecules from read positions on lines, CP.cc:952)."""
    n_reads = paths_edges.shape[0]
    mol_lens = []
    e0 = np.where(path_len > 0, paths_edges[:, 0], -1)
    for b in range(1, rs.n_barcodes + 1):
        lo, hi = int(rs.bci[b]), int(rs.bci[b + 1])
        if hi - lo < 2:
            continue
        by_edge: Dict[int, list] = {}
        for r in range(lo, min(hi, n_reads)):
            if e0[r] >= 0:
                by_edge.setdefault(int(e0[r]), []).append(int(offset[r]))
        for e, poss in by_edge.items():
            if len(poss) >= 2:
                mol_lens.append(max(poss) - min(poss) + 150)
    return np.asarray(mol_lens, dtype=np.int64)


def plot_histogram_json(json_path: str | Path, png_path: str | Path, log_y=True):
    """Render a histogram JSON to PNG (plot.py analogue)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = json.loads(Path(json_path).read_text())
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.bar(data["bins"], data["counts"],
           width=max(1, (data["bins"][1] - data["bins"][0]) if len(data["bins"]) > 1 else 1))
    if log_y:
        ax.set_yscale("symlog")
    ax.set_title(data.get("description", ""))
    fig.tight_layout()
    fig.savefig(png_path, dpi=100)
    plt.close(fig)
