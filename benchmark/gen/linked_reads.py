"""Barcoded linked reads of a diploid genome, made from a seed in a few
large tensor calls.

The model is the Chromium model of `supernova_tpu_torch/sim/genome.py`
(`simulate_linked_reads(chromium_model=True)`, as the `simulate` command
calls it), vectorised:

- a random genome of `genome_size` bases with `repeats` chunks of
  `repeat_len` bases pasted elsewhere; the second haplotype carries a SNP
  at each base with probability `het_rate`;
- `barcodes` distinct barcode ids out of `whitelist_size`; per barcode
  max(1, Poisson(`molecules_per_barcode`)) molecules, each on a random
  haplotype, of length Exponential(`molecule_len`) clipped to
  [`min_molecule_len`, genome], at a uniform start;
- each molecule weighs max(1, mlen * `mol_coverage` / (2 * read_len))
  pairs, and exactly `pairs` pairs are drawn over the molecules by those
  weights, so every seed yields the same number of bases;
- a pair is a fragment of `insert` bases at a uniform place in its
  molecule: R1 its first `read_len` bases, R2 the reverse complement of
  its last; every base is substituted with probability `error_rate` (its
  quality then `error_qual`, else `base_qual`);
- each of the 16 barcode bases is wrong with probability
  `bc_error_rate`; a barcode with at most one wrong base is corrected to
  its id, one with more is unbarcoded (id 0);
- the traffic's `r1_trim` drops that many leading bases of every R1.

Pairs are sorted by barcode id (stable), mates adjacent, as ingest leaves
them.  The same seed on the same device type gives the same reads.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Reads:
    """A readset as flat host arrays: what the program's ReadSet holds."""

    codes: np.ndarray  # uint8 base codes 0..3, all reads back to back
    offsets: np.ndarray  # int64 (n_reads + 1,)
    quals: np.ndarray  # uint8, as codes
    bc: np.ndarray  # int32 (n_reads,) barcode id, 0 = unbarcoded
    bci: np.ndarray  # int64 (whitelist_size + 2,) first read of each id

    @property
    def n_reads(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_bases(self) -> int:
        return int(self.offsets[-1])


def _randint(g, lo, hi, n, dev):
    return torch.randint(lo, hi, (n,), generator=g, device=dev)


def generate(cfg: dict, seed: int, device, r1_trim: int = 0) -> Reads:
    """The readset of configuration `cfg` (the keys named in the module's
    docstring) for `seed`, drawn on `device`."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    G, rl, ins = int(cfg["genome_size"]), int(cfg["read_len"]), int(cfg["insert"])
    n_pairs = int(cfg["pairs"])

    # genome, repeats, second haplotype
    hap_a = _randint(g, 0, 4, G, dev).to(torch.uint8)
    rlen = int(cfg["repeat_len"])
    n_rep = int(cfg["repeats"])
    if n_rep:
        src_dst = _randint(g, 0, G - rlen, 2 * n_rep, dev).tolist()
        for src, dst in zip(src_dst[0::2], src_dst[1::2]):
            hap_a[dst : dst + rlen] = hap_a[src : src + rlen].clone()
    snp = torch.rand(G, generator=g, device=dev) < float(cfg["het_rate"])
    shift = _randint(g, 1, 4, G, dev).to(torch.uint8)
    hap_b = torch.where(snp, (hap_a + shift) % 4, hap_a)
    haps = torch.cat([hap_a, hap_b])

    # barcodes and molecules
    wl = int(cfg["whitelist_size"])
    ids = torch.randperm(wl, generator=g, device=dev)[: int(cfg["barcodes"])] + 1
    rate = torch.full((ids.shape[0],), float(cfg["molecules_per_barcode"]), device=dev)
    n_mols = torch.poisson(rate, generator=g).long().clamp(min=1)
    mol_bc = torch.repeat_interleave(ids, n_mols)
    m = mol_bc.shape[0]
    mol_hap = _randint(g, 0, 2, m, dev)
    mlen = torch.empty(m, dtype=torch.float64, device=dev).exponential_(
        1.0 / float(cfg["molecule_len"]), generator=g)
    mlen = mlen.long().clamp(int(cfg["min_molecule_len"]), G)
    mstart = (torch.rand(m, generator=g, device=dev, dtype=torch.float64)
              * (G - mlen + 1)).long()
    weight = (mlen * float(cfg["mol_coverage"]) / (2 * rl)).long().clamp(min=1)

    # exactly n_pairs pairs over the molecules, by weight
    mol = torch.multinomial(weight.double(), n_pairs, replacement=True, generator=g)
    span = (mlen[mol] - ins).clamp(min=1)
    fs = mstart[mol] + (torch.rand(n_pairs, generator=g, device=dev, dtype=torch.float64)
                        * span).long()
    base = mol_hap[mol] * G + fs
    bc = mol_bc[mol]

    # barcode read errors: one wrong base is corrected, more are unbarcoded
    bc_wrong = (torch.rand((n_pairs, 16), generator=g, device=dev)
                < float(cfg["bc_error_rate"])).sum(1)
    bc = torch.where(bc_wrong <= 1, bc, 0).to(torch.int32)

    # pairs in barcode order (stable), R1 then R2
    order = torch.sort(bc, stable=True).indices
    bc, base = bc[order], base[order]
    col = torch.arange(rl, device=dev)
    r1 = haps[base[:, None] + col[None, :]]
    r2 = haps[base[:, None] + (ins - 1) - col[None, :]] ^ 3
    reads = torch.stack([r1, r2], dim=1).reshape(2 * n_pairs, rl)
    del r1, r2

    err = torch.rand(reads.shape, generator=g, device=dev) < float(cfg["error_rate"])
    sub = torch.randint(1, 4, reads.shape, generator=g, device=dev, dtype=torch.uint8)
    reads = torch.where(err, (reads + sub) % 4, reads)
    quals = torch.where(err, int(cfg["error_qual"]), int(cfg["base_qual"])).to(torch.uint8)
    del err, sub

    lens = torch.full((2 * n_pairs,), rl, dtype=torch.int64, device=dev)
    if r1_trim:
        keep = torch.ones(reads.shape, dtype=torch.bool, device=dev)
        keep[0::2, :r1_trim] = False
        lens[0::2] = rl - r1_trim
        codes, quals = reads[keep], quals[keep]
    else:
        codes, quals = reads.reshape(-1), quals.reshape(-1)
    offsets = torch.zeros(2 * n_pairs + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(lens, 0)
    bc_read = torch.repeat_interleave(bc, 2)
    bci = torch.searchsorted(bc_read, torch.arange(wl + 2, device=dev, dtype=torch.int32))
    host = lambda t: t.cpu().numpy()
    return Reads(host(codes), host(offsets), host(quals), host(bc_read), host(bci).astype(np.int64))
