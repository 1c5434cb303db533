"""supernova_tpu_torch — the PyTorch/CUDA port of the JAX package `supernova_tpu`.

The JAX package `supernova_tpu` is the reference; this package computes the
same tables, graphs and read paths with PyTorch tensors, and replaces each
Pallas TPU kernel with a hand-written CUDA C++ kernel for Hopper (sm_90a).
It never imports `jax`, nor any module of `supernova_tpu`: the host
modules it needs are its own copies (core dna/ragged/pqvec, ingest, sim,
stats gems/histograms/logger).

Ported so far (the base-graph slice of the main path):
  core/device.py     explicit device resolution (no CPU fallback)
  core/kmer_codec.py 48-mer words as three int64 tensors (W3)
  ops/segments.py    run masks and stable compaction
  ops/kernels/       K1 kmer_extract, K2 compact, K3 run_reduce, K4 sort
                     (+ plain twins)
  kmer/count.py      single-block and blocked count -> KmerTable
  dbg/build.py       unipath graph build -> DeviceGraph
  dbg/graph.py       BaseGraph (byte-compatible save/load)
  align/pather.py    fused uniform-read pather, single-block and blocked
                     -> ReadPaths
  stats/trace.py     per-stage wall time and peak device memory
  pipeline/run.py    Pipeline: ingest -> count -> graph -> paths
  convert.py         numpy <-> tensor bridges to the reference's outputs
"""

__version__ = "0.1.0"
