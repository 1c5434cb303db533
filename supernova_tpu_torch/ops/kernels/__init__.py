"""The port's hand-written Hopper kernels, each beside its plain twin.

  K1 kmer_extract.sliding_words  <- ops/pallas/kmer_extract.py
  K2 compact.compact             <- ops/pallas/compact.py
  K3 run_reduce.run_reduce       <- ops/pallas/run_reduce.py
  K4 sort.lex_argsort            <- ops/pallas/sort.py

Each wrapper runs its plain PyTorch twin for CPU tensors and launches its
CUDA kernel for CUDA tensors (raising on anything the kernel does not
take).  `wrapper.launches` counts kernel launches made through the wrapper.
"""
from __future__ import annotations

from . import compact, kmer_extract, run_reduce, sort

WRAPPERS = {
    "kmer_extract": kmer_extract.sliding_words,
    "compact": compact.compact,
    "run_reduce": run_reduce.run_reduce,
    "sort": sort.lex_argsort,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
