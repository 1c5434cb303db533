"""Heterozygosity estimate: sample bubbles, align arm vs arm, SNP rate.

The port's own copy of supernova_tpu/asm/het.py, apart from
estimate_hetdist's `device`, where ops/alignment.py's align_pairs runs the
arm-vs-arm DP, and its `info`, which receives the DP's pairs, shape and
seconds; tests/test_torch_hostcopies.py holds the rest to the original.

Reference: CP.cc:1486-1557 — sample line bubbles, SmithWatAffine the two
arms, count substitutions, divide into assembly span -> `hetdist` (mean
distance between het sites).
"""
from __future__ import annotations



import numpy as np

from ..core.kmer_codec import K
from ..ops.alignment import MIS, align_pairs


def estimate_hetdist(D, lines, device, max_bubbles: int = 200,
                     info: dict | None = None) -> float | None:
    """-> estimated mean distance between het SNPs, or None if no bubbles."""
    def path_bases(path):
        parts = [D.edge_bases(int(path[0]))]
        for d in path[1:]:
            parts.append(D.edge_bases(int(d))[K - 1 :])
        return np.concatenate(parts)

    pairs = []
    total_span = 0
    for ln in lines.lines:
        for el in ln.elements:
            if len(el) == 2 and len(pairs) < max_bubbles:
                a = path_bases(el.paths[0])
                b = path_bases(el.paths[1])
                if len(a) < 20_000 and len(b) < 20_000:
                    pairs.append((a.astype(np.int32), b.astype(np.int32)))
                    total_span += (len(a) + len(b)) // 2
    if not pairs:
        return None
    pen = align_pairs(pairs, device, info=info)
    # each substitution costs MIS; indels contribute too but substitutions
    # dominate at typical het rates — floor at 1 SNP per sampled bubble
    snps = np.maximum(pen // MIS, 1).sum()
    if snps == 0:
        return None
    return float(total_span) / float(snps)
