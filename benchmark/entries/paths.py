"""Entry `paths`: supernova_tpu_torch.align.pather.path_readset on the
readset held in host memory, against the graph that set-up builds with the
program's count_readset, build_graph and from_device, to ReadPaths on the
card.  Its end-to-end metric is path_rate: reads of all calls over the
window."""
from __future__ import annotations

import gc

import torch

from .. import judge
from ..reference.count import count_table
from ..reference.graph import unipaths
from ..reference.kmers import MASK48
from ..reference.paths import path_reads
from . import readset
from .count import host_tensors


class Entry:
    span = "call.paths"

    def __init__(self, reads, device):
        from supernova_tpu_torch.align import pather

        self._path = pather.path_readset
        self.reads, self.device = reads, torch.device(device)
        self.rs = readset(reads)
        self.bg = None

    def prepare(self) -> dict:
        """The graph the calls path against, as the pipeline's count and
        graph stages make it."""
        from supernova_tpu_torch.dbg import build, graph
        from supernova_tpu_torch.kmer import count as kcount

        info: dict = {}
        table = kcount.count_readset(self.rs, self.device, info=info)
        self.bg = graph.from_device(build.build_graph(table), table)
        del table
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"count_info": info, "kmers": int(self.bg.n_kmers), "edges": int(self.bg.n_edges)}

    def call(self, info: dict):
        return self._path(self.bg, self.rs, self.device, info=info)

    def columns(self, out) -> list:
        return judge.paths_columns_program(out, self.reads.n_reads)

    @staticmethod
    def fault(info: dict) -> str | None:
        return None

    def end_to_end(self, calls: int, window_s: float) -> dict:
        return {"path_rate": (self.reads.n_reads * calls / window_s, "reads/s")}

    def release(self) -> None:
        self.rs = self.bg = None

    def reference(self, lo_mask: int = MASK48) -> list:
        """The reference's own table and graph, then its paths; lo_mask
        shortens the pather's lookup key only (the control)."""
        codes, quals, offsets, bc = host_tensors(self.reads, self.device)
        t = count_table(codes, quals, offsets, bc)
        del quals, bc
        gr = unipaths(t)
        return judge.paths_columns_reference(path_reads(codes, offsets, t, gr, lo_mask=lo_mask))

    compare = staticmethod(judge.compare_paths)
