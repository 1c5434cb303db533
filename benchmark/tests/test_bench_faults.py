"""The comparison that decides `correct` fails where it must, at a small
size on the CPU:

- the control (benchmark/control.py: the reference on a 64-bit kmer key)
  fails every cell on three seeds;
- a run whose timed path is broken underneath comes out not correct: half
  of the reads left out, and one answer altered where it is produced.

The cells' calls keep no state between calls and run on one card, so the
faults "a step that returns its state unchanged" and "the exchange between
chips left out" have nothing to act on here.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import control, run
from supernova_tpu_torch.align import pather
from supernova_tpu_torch.ingest.reads import ReadSet
from supernova_tpu_torch.kmer import count as kcount

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def small(name: str) -> dict:
    cell = next(w for w in SPEC["workloads"] if w["name"] == name)
    conf = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    cfg.update(genome_size=30_000, repeats=2, barcodes=40, whitelist_size=128,
               molecule_len=6_000, pairs=3000)
    return cfg


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 9, 4_100_000_013])
def test_the_control_fails(name, seed):
    numbers = control.control_numbers(name, seed, "cpu", small(name))
    assert any(v > 0 for v in numbers.values()), numbers


def first_half(rs: ReadSet) -> ReadSet:
    """The readset's first half of pairs."""
    k = rs.n_reads // 4 * 2
    end = int(rs.offsets[k])
    return ReadSet(codes=rs.codes[:end], offsets=rs.offsets[: k + 1], quals=rs.quals[:end],
                   bc=rs.bc[:k], bci=np.minimum(rs.bci, k), barcoded=rs.barcoded)


def count_half(real):
    return lambda rs, device, **kw: real(first_half(rs), device, **kw)


def count_altered(real):
    def f(rs, device, **kw):
        t = real(rs, device, **kw)
        t.count[0] += 1  # one kmer's count, as the count produces it
        return t
    return f


def paths_half(real):
    return lambda bg, rs, device, **kw: real(bg, first_half(rs), device, **kw)


def paths_altered(real):
    def f(bg, rs, device, **kw):
        rp = real(bg, rs, device, **kw)
        rp.offset[0] += 1  # one read's answer, as the pather produces it
        return rp
    return f


FAULTS = {
    "count_half": (kcount, "count_readset", count_half),
    "count_altered": (kcount, "count_readset", count_altered),
    "paths_half": (pather, "path_readset", paths_half),
    "paths_altered": (pather, "path_readset", paths_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    module, attr, breaker = FAULTS[fault]
    name = "count.val10mb" if module is kcount else "paths.val10mb"
    monkeypatch.setattr(module, attr, breaker(getattr(module, attr)))
    res = run.run_cell(name, 2**31 + 5, 0.1, False, "cpu", SPEC, small(name))
    assert res["correct"] is False
    # every call of the window and the warm call
    assert res["checks"]["calls_off"]["value"] == res["attempted"] + 1
    assert max(c["value"] for k, c in res["checks"].items() if k != "calls_off") > 0
