"""BaseGraph: host-side unipath graph container (port of
supernova_tpu/dbg/graph.py; the reference module imports jax through its
codec, so the container is copied here).

`save`/`load` write and read the reference's graph.npz layout with the same
array dtypes; `device_arrays(device)` hands the pather torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..core import dna
from ..core import kmer_codec as kc
from ..core.kmer_codec import K
from ..core.ragged import Ragged
from .. import native


@dataclass
class BaseGraph:
    edges: Ragged  # edge base codes (uint8 values)
    inv: np.ndarray  # (E,) int32
    from_v: np.ndarray  # (E,) int32
    to_v: np.ndarray  # (E,) int32
    n_vertices: int
    is_circle: np.ndarray  # (E,) bool
    # kmer dictionary (for read pathing): sorted canonical kmer words +
    # oriented-node -> (edge, pos) map; row r, dir d -> node 2r+d
    kmer_words: np.ndarray | None = None  # (M, 3) uint32 sentinel-padded
    node_edge: np.ndarray | None = None  # (2M,) int32
    node_pos: np.ndarray | None = None  # (2M,) int32
    n_kmers: int = 0

    @property
    def n_edges(self) -> int:
        return self.edges.n_rows

    def edge_len(self, e: int) -> int:
        return int(self.edges.offsets[e + 1] - self.edges.offsets[e])

    def kmers(self, e: int) -> int:
        """#kmers on edge e (HyperBasevector::Kmers)."""
        return self.edge_len(e) - K + 1

    def edge_seq(self, e: int) -> str:
        return dna.codes_to_seq(self.edges.row(e))

    def total_kmers(self) -> int:
        return int((self.edges.lengths() - (K - 1)).sum())

    def checksum(self) -> int:
        """Deterministic FNV-1a over the sorted edge sequences: the
        reference's 64-bit value, by native/fnv.cpp over their concatenation
        (the Python loop, on integers masked to 64 bits, takes ~0.7 us a
        byte: ~17 s a 10 Mb graph; it runs where g++ is missing)."""
        data = b"".join(s.encode() for s in sorted(self.edge_seq(e)
                                                   for e in range(self.n_edges)))
        h = 0xCBF29CE484222325
        fast = native.fnv1a_64(data, h)
        if fast is not None:
            return fast
        prime = 0x100000001B3
        mask = (1 << 64) - 1
        for b in data:
            h = ((h ^ b) * prime) & mask
        return h

    def device_arrays(self, device) -> dict:
        """Dictionary + topology tensors for the pather on `device`, made
        once per device and cached on the instance (graphs are immutable
        after construction)."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_device_arrays", {})
        da = cache.get(device)
        if da is None:
            t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
            da = dict(
                words=kc.np_to_soa(self.kmer_words, device),
                node_edge=t(self.node_edge),
                node_pos=t(self.node_pos),
                from_v=t(self.from_v),
                to_v=t(self.to_v),
                edge_kmers=t(self.edges.lengths() - (K - 1)),
            )
            cache[device] = da
        return da

    def __getstate__(self):
        """Pickle the graph without its device tensors (assembly_state.pkl
        holds the host arrays only, as the reference's does)."""
        state = dict(self.__dict__)
        state.pop("_device_arrays", None)
        return state

    def validate(self):
        E = self.n_edges
        assert len(self.inv) == E and len(self.from_v) == E and len(self.to_v) == E
        lens = self.edges.lengths()
        assert (lens >= K).all(), "edge shorter than K"
        inv = self.inv
        assert ((inv >= 0) & (inv < E)).all()
        assert np.array_equal(inv[inv], np.arange(E)), "inv not an involution"
        for e in range(E):
            re = int(inv[e])
            if self.is_circle[e]:
                # rc of a circular unipath may be emitted at another rotation
                s = self.edge_seq(e)
                core = s[: len(s) - (K - 1)]
                rcs = dna.codes_to_seq(dna.revcomp(self.edges.row(re)))
                rcore = rcs[: len(rcs) - (K - 1)]
                assert len(core) == len(rcore) and rcore in core + core, e
            else:
                assert np.array_equal(
                    self.edges.row(re), dna.revcomp(self.edges.row(e))
                ), f"inv edge {re} is not rc of {e}"
        # K-1 overlap at shared vertices
        starts47 = {}
        for e in range(E):
            starts47.setdefault(int(self.from_v[e]), set()).add(self.edge_seq(e)[: K - 1])
        for v, ss in starts47.items():
            assert len(ss) == 1, f"vertex {v} has inconsistent out 47-mers"
        ends47 = {}
        for e in range(E):
            ends47.setdefault(int(self.to_v[e]), set()).add(self.edge_seq(e)[-(K - 1):])
        for v, ss in ends47.items():
            assert len(ss) == 1, f"vertex {v} has inconsistent in 47-mers"

    def save(self, path: str | Path):
        np.savez_compressed(
            path,
            values=self.edges.values,
            offsets=self.edges.offsets,
            inv=self.inv,
            from_v=self.from_v,
            to_v=self.to_v,
            n_vertices=np.int64(self.n_vertices),
            is_circle=self.is_circle,
            kmer_words=self.kmer_words if self.kmer_words is not None else np.zeros((0, 3), np.uint32),
            node_edge=self.node_edge if self.node_edge is not None else np.zeros(0, np.int32),
            node_pos=self.node_pos if self.node_pos is not None else np.zeros(0, np.int32),
            n_kmers=np.int64(self.n_kmers),
        )

    @staticmethod
    def load(path: str | Path) -> "BaseGraph":
        z = np.load(path)
        kw = z["kmer_words"]
        return BaseGraph(
            edges=Ragged(z["values"], z["offsets"]),
            inv=z["inv"],
            from_v=z["from_v"],
            to_v=z["to_v"],
            n_vertices=int(z["n_vertices"]),
            is_circle=z["is_circle"],
            kmer_words=kw if len(kw) else None,
            node_edge=z["node_edge"] if len(z["node_edge"]) else None,
            node_pos=z["node_pos"] if len(z["node_pos"]) else None,
            n_kmers=int(z["n_kmers"]),
        )


def from_device(dg, table=None) -> BaseGraph:
    """DeviceGraph (+ optional KmerTable for the dictionary) -> BaseGraph
    with the reference's host dtypes."""
    i32 = lambda x: x.cpu().numpy().astype(np.int32)
    bg = BaseGraph(
        edges=Ragged(
            dg.edge_codes.cpu().numpy().astype(np.uint8),
            dg.edge_offsets.cpu().numpy().astype(np.int64),
        ),
        inv=i32(dg.inv),
        from_v=i32(dg.from_v),
        to_v=i32(dg.to_v),
        n_vertices=int(dg.n_vertices),
        is_circle=dg.is_circle.cpu().numpy(),
        node_edge=i32(dg.node_edge),
        node_pos=i32(dg.node_pos),
    )
    if table is not None:
        bg.kmer_words = kc.soa_to_np(table.words)
        bg.n_kmers = int(table.n_valid)
    return bg
