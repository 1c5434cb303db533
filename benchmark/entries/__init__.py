"""The program's entries a cell's window can drive, one module each,
found by the name in the traffic file's `entry` key.  A module defines
`Entry(reads, device)` with `span` (the name of the benchmark's span
around each call), prepare() (set-up beyond the warm call; returns what
to print), call(info), columns(out) (the output judged, as integer
tensors), fault(info) (why a call counts as failed, or None),
end_to_end(calls, window_s) ({metric: (value, unit)}), release(),
reference(lo_mask) (the reference's columns in the program's layout) and
compare(program_columns, reference_columns) ({number: value}, each held
to 0)."""
from __future__ import annotations

import importlib


def readset(reads):
    """The program's ReadSet over the generated host arrays."""
    from supernova_tpu_torch.ingest.reads import ReadSet

    return ReadSet(codes=reads.codes, offsets=reads.offsets, quals=reads.quals,
                   bc=reads.bc, bci=reads.bci, barcoded=True)


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}").Entry
