"""supernova_tpu_torch — the PyTorch/CUDA port of supernova_tpu.

The JAX package `supernova_tpu` is the reference; this package computes the
same tables, graphs and read paths with PyTorch tensors, and replaces each
Pallas TPU kernel with a hand-written CUDA C++ kernel for Hopper (sm_90a).
It never imports `jax`.  It imports only the jax-free host modules of
`supernova_tpu` (ingest, sim, core.ragged/dna, stats.logger/histograms/gems,
align.pathzip).

Ported so far (the base-graph slice of the main path):
  core/device.py     explicit device resolution (no CPU fallback)
  core/kmer_codec.py 48-mer words as three int64 tensors (W3)
  ops/segments.py    run masks and stable compaction
  ops/kernels/       K1 kmer_extract, K2 compact, K3 run_reduce (+ plain twins)
  kmer/count.py      single-block count -> KmerTable
  dbg/build.py       unipath graph build -> DeviceGraph
  dbg/graph.py       BaseGraph (byte-compatible save/load)
  align/pather.py    fused uniform-read pather -> ReadPaths
  stats/trace.py     per-stage wall time and peak device memory
  pipeline/run.py    Pipeline: ingest -> count -> graph -> paths
  convert.py         numpy <-> tensor bridges to the reference's outputs
"""

__version__ = "0.1.0"
