"""Block spills of the blocked count: the layout of
supernova_tpu/kmer/count.py:914-1002, on the host.

Each block's kept raw rows go to disk as five `.npy` columns
`b{i}_{j}.npy` -- words a, b, c as uint32, count as int32, stats as uint32:
20 B a row -- and are memory-mapped back for the merge, so the host holds
no copy of them.  A persistent directory also holds `meta.json` (the block
plan and the filter: the reference's keys, and the block size) and a
`b{i}.ok` marker for each finished block, so a killed count resumes block
by block; a meta that differs clears the directory.  A count with no
explicit block size takes the one the meta records (read_meta), so a
resume keeps its blocks whatever the card has free.  The meta has no
fingerprint of the reads' content (the reference's known defect, kept for
parity).  Without a directory a temporary one is used and removed on
close.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np

# dtypes of the five spilled columns: words a, b, c, count, stats
COLUMN_DTYPES = (np.uint32, np.uint32, np.uint32, np.int32, np.uint32)


def read_meta(path: str | os.PathLike) -> dict | None:
    """The meta.json of a spill directory, or None when it has none."""
    try:
        with open(os.path.join(os.fspath(path), "meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class SpillDir:
    """Where one blocked count keeps its blocks' raw rows.  A context
    manager: a temporary directory is removed on exit, a persistent one is
    kept for a resume (its owner removes it)."""

    def __init__(self, path: str | os.PathLike | None, meta: dict):
        self.persistent = path is not None
        if not self.persistent:
            self.path = tempfile.mkdtemp(prefix="snb_spill_")
            return
        self.path = os.fspath(path)
        meta_path = os.path.join(self.path, "meta.json")
        os.makedirs(self.path, exist_ok=True)
        if read_meta(self.path) != meta:
            shutil.rmtree(self.path, ignore_errors=True)
            os.makedirs(self.path)
            with open(meta_path, "w") as f:
                json.dump(meta, f)

    def _column(self, i: int, j: int) -> str:
        return os.path.join(self.path, f"b{i}_{j}.npy")

    def _ok(self, i: int) -> str:
        return os.path.join(self.path, f"b{i}.ok")

    def done(self, i: int) -> bool:
        """Block i was spilled whole by an earlier run (persistent only)."""
        return self.persistent and os.path.exists(self._ok(i))

    def load(self, i: int) -> tuple[np.ndarray, ...]:
        """Block i's five columns, memory-mapped read-only."""
        return tuple(np.load(self._column(i, j), mmap_mode="r") for j in range(5))

    def save(self, i: int, cols) -> tuple[np.ndarray, ...]:
        """Write block i's five host columns (COLUMN_DTYPES), mark the block
        done, and return the columns memory-mapped back."""
        for j, (x, dt) in enumerate(zip(cols, COLUMN_DTYPES, strict=True)):
            if x.dtype != dt:
                raise TypeError(f"spill column {j} is {x.dtype}, expected {np.dtype(dt)}")
            np.save(self._column(i, j), x)
        if self.persistent:
            with open(self._ok(i), "w") as f:
                f.write(str(len(cols[0])))
        return self.load(i)

    def close(self) -> None:
        if not self.persistent:
            shutil.rmtree(self.path, ignore_errors=True)

    def __enter__(self) -> SpillDir:
        return self

    def __exit__(self, *exc) -> None:
        self.close()
