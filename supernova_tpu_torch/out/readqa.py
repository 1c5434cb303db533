"""Read-QA report — the `_ALIGNER` pipeline's QA products, natively.

The port's own copy of supernova_tpu/out/readqa.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

The reference keeps an internal BAM QA path (mro/_aligner.mro:31,
mro/stages/reads/): BWA-align reads to a *reference genome*, attach
barcodes, and emit `duplicate_summary` (mark_duplicates/__init__.py:
100-183), `lot_info` (trim_reads/__init__.py:91-154), and sorted BAMs.  A
de novo assembler has no reference genome; the native equivalent aligns
reads to the *assembly* (which the pipeline already does — the paths are
the alignments) and derives the same QA products from the placements:

  duplicate_summary.json  dup-group histograms with and without barcode
                          splitting ("full_use_bcs"/"full_ignore_bcs" —
                          same keys as DupSummary descriptions).  The
                          "optical_*"/"diffusion_*" classes need flowcell
                          (lane, x, y) coordinates from Illumina read
                          names, which the ingested store does not keep —
                          reported as null with a note.
  lot_info.json           gelbead lot detection from barcode part-A
                          prefixes (identify_gelbead_lot behavior parity;
                          oligo tables from tenkit/constants.py:1254-1308).
  readqa.json             mapped/placed fraction, dup fractions, median
                          insert + proper-pair fraction, valid-barcode
                          fraction, reads-per-barcode N50.

SAM exports (bcsorted/possorted analogues) come from out/sam.py.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# Chromium/GemCode lot-specific part-A oligos (constant-table parity with
# tenkit/lib/python/tenkit/constants.py:1254-1308)
CHROMIUM_LOT_MAP = {
    "Chromium Lot 1": ["AGAGCGA", "CGATTGA", "TAGACCA", "AAATGCC",
                       "CTTTGCG", "TCAGCAA", "CTCCTAG", "ATTATCC"],
    "Chromium Lot 2": ["GACACTA", "CCCTCTC", "ATCGCGG", "CTGGCAG",
                       "CCAGCTT", "CATAGCA", "CGTGTTC", "GCACCAG"],
    "Chromium Lot 3": ["ATGTGAC", "GACGTCG", "ACTGGCG", "TGGCAAT",
                       "GAGGGTA", "GTTTCGC", "CAAGTGT", "TTGAAGC"],
    "Chromium Lot 4": ["CGATCCT", "TGTTGCC", "ACCTATT", "ACAACTG",
                       "CTGTGTC", "CTGGAAT", "CAGAGTT", "GGGCTGT"],
    "Chromium Lot 5": ["TAGCTCC", "CAATTTC", "GCTCGAG", "GAAGGCA",
                       "CGGCATG", "TATTCCA", "TCTCTGG", "AGGTACT"],
    "Chromium Lot 6": ["ACTTGCC", "GTGAGTT", "GTTGTCC", "CATAACG",
                       "TCGTAAG", "TTATCCA", "GTGGAGA", "TCCTGCA"],
    "Chromium Lot 7": ["TAAGCCA", "TCGGTGG", "AAGGTAA", "GGAACAG",
                       "GTGGAAG", "TTAGACG", "ATCCTAT", "TTCCGTG"],
    "Chromium Lot 8": ["GGTTTAG", "CGTATAG", "ATAGGCT", "CTCTCGA",
                       "GTCTTAT", "GATTGCA", "TGAGCTA", "ACGCGTG"],
    "Chromium Lot 9": ["CGACACG", "TCTCGTG", "TGATGAC", "TGCGTAA",
                       "TACCCTG", "AGGTGCC", "CTTGTGC", "GCATGGC"],
    "Chromium Lot 10": ["CAGCACG", "CATGATG", "ATCAACG", "GATAAGA",
                        "CTGGTTC", "CGATTCC", "AGGTGAG", "GGCCTGA"],
    "Chromium Lot 11": ["ACAGTTG", "TAAGCAC", "ATCTTTG", "TCTTGCG",
                        "TACATGG", "CAAGGTT", "AGGCTGC", "GGTCGTG"],
    "Chromium Lot 12": ["CCATTAT", "GTTGCGG", "AGGGTAG", "GCCCAAG",
                        "TGTGCCT", "ATTCTTG", "GGTGCCA", "GTATAGC"],
    "Chromium Lot 13": ["GGCATCG", "GACTGAT", "TGGTGTA", "TCCGTTG",
                        "CCTTCAG", "CAGGCCA", "GCACCGA", "AGATCCA"],
}

GEMCODE_LOT_MAP = {
    "GemCode Lots 1-15": ["GGGTGA", "TTCATC", "CACAAC", "GAAGAT",
                          "CAGCAT", "CGTCAA", "GAAACA", "TGTTTC"],
    "GemCode Lot 16": ["CAAGTC", "ACAAAG", "CTGGAT", "TTGTCT",
                       "AGCCTA", "GGGAAC", "TTCCTA", "CCGTAA"],
    "GemCode Lot 17": ["AGTCCA", "CAGGAG", "CAATGC", "CAATCG",
                       "AACAGA", "TTACTC", "ACTGAC", "TAAGCC"],
    "GemCode Lot 18": ["GCATGT", "CCAACA", "TCGGTA", "ATCGTG",
                       "ATTCTC", "CGTTAG", "TTCACT", "GGTTTG"],
    "GemCode Lot 19": ["CTTTCA", "TTGTTC", "TAGCCA", "GCGTAT",
                       "CGTACA", "CCTTCG", "CACACA", "TACTTC"],
    "GemCode Lot 20": ["CTTCAT", "ATTCCT", "GTCTCC", "CAGGGA",
                       "ATCCGA", "CGAATC", "AAACCC", "CGCTAA"],
    "GemCode Lot 21": ["CAGATC", "AATCCG", "TACGTG", "GAACAA",
                       "AGAGCG", "CCAGAT", "CGCTTC", "TTATCC"],
}

# whitelist name -> lot map (constants.py:1305-1308): whitelists absent
# from this map carry no lot oligos and skip detection
WHITELIST_TO_LOT_MAP = {
    "884K-november-2015": GEMCODE_LOT_MAP,
    "4M-with-alts-february-2016": CHROMIUM_LOT_MAP,
}


def identify_gelbead_lot(bc_hist: dict, lot_to_bcs: dict,
                         min_frac: float = 0.95, min_counts: int = 1000):
    """Behavior parity with trim_reads/__init__.py:124-154: count barcode
    observations whose part-A prefix matches each lot's oligos; confident
    when the best lot holds >= 95% of >= 1000 matched counts."""
    bc_to_lot = {
        bc: lot for lot, bcs in lot_to_bcs.items() for bc in bcs
    }
    lot_counts = {lot: 0 for lot in lot_to_bcs}
    part_a_len = len(next(iter(bc_to_lot)))
    for bc, count in bc_hist.items():
        lot = bc_to_lot.get(bc[:part_a_len])
        if lot is not None:
            lot_counts[lot] += int(count)
    best_lot = max(lot_counts, key=lambda lot: lot_counts[lot])
    best_counts = lot_counts[best_lot]
    total = sum(lot_counts.values())
    best_frac = best_counts / total if total > 0 else 0.0
    if best_frac >= min_frac and total >= min_counts:
        return best_lot, "confident", lot_counts
    if total < min_counts:
        return None, "insufficient data", lot_counts
    return None, "ambiguous", lot_counts


def _dup_groups(paths_edges, path_len, offset, bc, use_bcs: bool):
    """Pair dup-group sizes keyed on mate placements (MarkDups key,
    SecretOps.cc:413,599), optionally split by barcode."""
    n_reads = paths_edges.shape[0]
    n_pairs = n_reads // 2
    e0 = np.where(path_len > 0, paths_edges[:, 0], -1)
    off = np.where(path_len > 0, offset, 0)
    r1 = np.arange(0, n_reads, 2)
    r2 = r1 + 1
    cols = [e0[r1], off[r1], e0[r2], off[r2]]
    if use_bcs:
        cols = [np.asarray(bc)[r1].astype(np.int64)] + cols
    key = np.stack([np.asarray(c, np.int64) for c in cols], axis=1)
    placed = (e0[r1] >= 0) | (e0[r2] >= 0)
    key = key[placed]
    if key.shape[0] == 0:
        return np.zeros(0, np.int64)
    order = np.lexsort(key.T[::-1])
    ks = key[order]
    first = np.ones(ks.shape[0], bool)
    first[1:] = np.any(ks[1:] != ks[:-1], axis=1)
    gid = np.cumsum(first) - 1
    return np.bincount(gid)


def duplicate_summary(paths_edges, path_len, offset, bc) -> dict:
    """DupSummary-equivalent report (mark_duplicates/__init__.py:100-183):
    group-size histograms + dup counts, with and without barcode
    splitting.  Optical/diffusion classes are null (no flowcell lane
    coordinates in the ingested store)."""
    out = {}
    for desc, use_bcs in (("full_use_bcs", True), ("full_ignore_bcs", False)):
        sizes = _dup_groups(paths_edges, path_len, offset, bc, use_bcs)
        hist = np.bincount(sizes) if len(sizes) else np.zeros(1, np.int64)
        n_pairs_placed = int(sizes.sum())
        n_dups = int((sizes - 1).clip(0).sum())
        out[desc] = {
            "dups": n_dups,
            "placed_pairs": n_pairs_placed,
            "dup_frac": (n_dups / n_pairs_placed) if n_pairs_placed else 0.0,
            "group_size_hist": {
                str(s): int(c) for s, c in enumerate(hist) if s > 0 and c > 0
            },
        }
        out["optical_" + desc] = None  # needs (lane,x,y) from read names
        out["diffusion_" + desc] = None
    return out


def readqa_report(bg, rs, paths_edges, path_len, offset) -> dict:
    """Top-level QA metrics over the read->assembly placements."""
    from ..asm.dups import insert_size_stats
    from ..stats.logger import n50

    pl = np.asarray(path_len)
    placed_frac = float((pl > 0).mean()) if len(pl) else 0.0
    med_ins, proper = insert_size_stats(bg, paths_edges, path_len, offset)
    bc = np.asarray(rs.bc)
    valid_bc_frac = float((bc > 0).mean()) if len(bc) else 0.0
    per_bc = np.diff(rs.bci)[1:]  # skip the unbarcoded block
    per_bc = per_bc[per_bc > 0]
    return {
        "reads": int(rs.n_reads),
        "placed_frac": placed_frac,
        "median_insert_size": med_ins,
        "proper_pairs_frac": proper,
        "valid_bc_frac": valid_bc_frac,
        "reads_per_barcode_n50": int(n50(per_bc)) if len(per_bc) else 0,
    }


def write_readqa(outdir, qa_dir=None, whitelist_path=None,
                 whitelist_name=None) -> dict:
    """CLI entry: load a finished run dir's checkpoints and write the
    three QA jsons.  Returns the paths written."""
    from ..align import pathzip
    from ..dbg.graph import BaseGraph
    from ..ingest.reads import ReadSet

    outdir = Path(outdir)
    qa_dir = Path(qa_dir) if qa_dir else outdir
    qa_dir.mkdir(parents=True, exist_ok=True)
    lz = outdir / "reads.lazy"
    if (lz / "codes.npy").exists():
        rs = ReadSet.load_lazy(lz)
    else:
        rs = ReadSet.load(outdir / "reads.npz")
    z = np.load(outdir / "paths.npz")
    n_edges = int(z["n_edges"]) if "n_edges" in z else None
    bg = None
    for name in ("graph.patched.npz", "graph.npz"):
        p = outdir / name
        if p.exists():
            cand = BaseGraph.load(p)
            if n_edges is None or cand.n_edges == n_edges:
                bg = cand
                break
    if bg is None:
        raise FileNotFoundError(f"no matching graph checkpoint in {outdir}")
    if "edges" in z:
        edges, plen, offset = z["edges"], z["path_len"], z["offset"]
    else:
        edges, plen, offset = pathzip.load_zipped(z, bg)
    edges = np.asarray(edges)
    plen = np.asarray(plen)
    offset = np.asarray(offset)

    paths = {}
    dup = duplicate_summary(edges, plen, offset, rs.bc)
    (qa_dir / "duplicate_summary.json").write_text(json.dumps(dup, indent=1))
    paths["duplicate_summary"] = str(qa_dir / "duplicate_summary.json")

    qa = readqa_report(bg, rs, edges, plen, offset)
    (qa_dir / "readqa.json").write_text(json.dumps(qa, indent=1))
    paths["readqa"] = str(qa_dir / "readqa.json")

    # lot detection needs the whitelist STRINGS (barcode ids alone cannot
    # recover part-A sequence); take the map by canonical name, or detect
    # over a user whitelist treated as Chromium-style
    lot_map = WHITELIST_TO_LOT_MAP.get(whitelist_name or "")
    lot_info = {"gelbead_lot": None,
                "gelbead_lot_confidence": "no lot oligos for whitelist",
                "gelbead_lot_counts": None}
    if lot_map is not None and whitelist_path:
        from ..core import dna

        wl = [ln.strip() for ln in open(whitelist_path) if ln.strip()]
        bc_counts = np.bincount(rs.bc, minlength=len(wl) + 1)
        bc_hist = {
            wl[b - 1]: int(c)
            for b, c in enumerate(bc_counts) if b >= 1 and c > 0
            and b - 1 < len(wl)
        }
        lot, conf, counts = identify_gelbead_lot(bc_hist, lot_map)
        lot_info = {
            "gelbead_lot": lot,
            "gelbead_lot_confidence": conf,
            "gelbead_lot_counts": {
                k: v for k, v in counts.items() if v > 0
            },
        }
    (qa_dir / "lot_info.json").write_text(json.dumps(lot_info, indent=1))
    paths["lot_info"] = str(qa_dir / "lot_info.json")
    return paths
