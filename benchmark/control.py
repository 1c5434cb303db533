"""The control of `correct`: the plain reference put in the program's place
with one guarantee of the configuration broken, judged as a run judges
the program.

    python3 -m benchmark.control --workload CELL --seeds N [N ...]

The guarantee broken is the 96-bit kmer: the control keys kmers on their
first 32 bases (64 bits, one machine word), the step that would tempt a
faster count or lookup.  For a count cell the count groups kmers on that
key; for a paths cell the pather's dictionary lookup matches on it (the
table and graph stay exact).  Per seed it prints the numbers a run
compares, for the control; each has to exceed its limit, 0.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import judge
from .entries import load
from .gen.linked_reads import generate
from .run import cell_parts, free, load_spec

KEY_32_BASES = 0xFFFF00000000  # lo's bits of bases 24..31


def control_numbers(name: str, seed: int, device, config: dict | None = None) -> dict:
    """The numbers compared for the control against the reference, one seed."""
    device = torch.device(device)
    _, cfg, traffic, _, _ = cell_parts(load_spec(), name)
    reads = generate(config or cfg, seed, device, r1_trim=int(traffic.get("r1_trim", 0)))
    free(device)
    entry = load(traffic["entry"])(reads, device)
    ref = entry.reference()
    fp_ref = judge.fingerprint(ref)
    ref = [c.cpu().numpy() for c in ref]
    free(device)
    ctl = entry.reference(lo_mask=KEY_32_BASES)
    numbers = {"calls_off": int(judge.fingerprint(ctl) != fp_ref)}
    numbers.update(entry.compare([c.cpu().numpy() for c in ctl], ref))
    free(device)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device")
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        n = control_numbers(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": n,
                          "seconds": time.perf_counter() - t,
                          "fails": any(v > 0 for v in n.values())}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
