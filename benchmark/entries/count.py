"""Entry `count`: supernova_tpu_torch.kmer.count.count_readset on the
readset held in host memory, to the adjacency-true KmerTable on the card.
Its end-to-end metric is count_rate: read bases (in Mbases) of all calls
over the window."""
from __future__ import annotations

import torch

from .. import judge
from ..reference.count import count_table
from ..reference.kmers import MASK48
from . import readset


class Entry:
    span = "call.count"

    def __init__(self, reads, device):
        from supernova_tpu_torch.kmer import count as kcount

        self._count = kcount.count_readset
        self.reads, self.device = reads, torch.device(device)
        self.rs = readset(reads)

    def prepare(self) -> dict:
        return {}

    def call(self, info: dict):
        return self._count(self.rs, self.device, info=info)

    @staticmethod
    def columns(out) -> list:
        return judge.table_columns_program(out)

    @staticmethod
    def fault(info: dict) -> str | None:
        """Why a call counts as failed: a count in more than one block
        spills every block to disk."""
        return None if info.get("blocks") == 1 else f"count in {info.get('blocks')} blocks"

    def end_to_end(self, calls: int, window_s: float) -> dict:
        return {"count_rate": (self.reads.n_bases * calls / 1e6 / window_s, "Mbases/s")}

    def release(self) -> None:
        self.rs = None

    def reference(self, lo_mask: int = MASK48) -> list:
        t = count_table(*host_tensors(self.reads, self.device), lo_mask=lo_mask)
        return judge.table_columns_reference(t)

    compare = staticmethod(judge.compare_tables)


def host_tensors(reads, device):
    """The reads' codes, quals, offsets and per-read barcodes on `device`."""
    t = lambda a: torch.from_numpy(a).to(device)
    return t(reads.codes), t(reads.quals), t(reads.offsets), t(reads.bc)
