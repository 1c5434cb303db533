"""supernova_tpu_torch — the PyTorch/CUDA port of the JAX package `supernova_tpu`.

The JAX package `supernova_tpu` is the reference; this package computes the
same tables, graphs, read paths, patched graphs and raw FASTA with PyTorch
tensors, and replaces each Pallas TPU kernel with a hand-written CUDA C++
kernel for Hopper (sm_90a).  It never imports `jax`, nor any module of
`supernova_tpu`: the host modules it needs are its own copies (core
dna/ragged/pqvec; ingest reads/ingest/barcodes/fastq/tenx/discovery; native
FASTQ decoder; sim; stats gems/histograms/logger; align rescue/pathzip/index;
asm bads/dups/stackster; out fasta; pipeline preflight).

Ported so far (the reference's Pipeline.run, from 10x FASTQs, and its patch
stage):
  core/device.py     explicit device resolution (no CPU fallback)
  core/kmer_codec.py 48-mer words as three int64 tensors (W3)
  ops/segments.py    run masks and stable compaction
  ops/kernels/       K1 kmer_extract, K2 compact, K3 run_reduce, K4 sort
                     (+ plain twins)
  kmer/count.py      single-block and blocked count (partitioned merge,
                     spill/resume, OOM retry) -> KmerTable
  kmer/spill.py      the blocked count's block spills
  dbg/build.py       unipath graph build -> DeviceGraph
  dbg/graph.py       BaseGraph (byte-compatible graph.npz)
  align/pather.py    fused uniform-read and general pathers, single-block
                     and blocked, with the OOM retry -> ReadPaths
  asm/patch.py       gap pairs and closures (host copies) and the graph
                     rebuild on the device (insert_patches)
  stats/trace.py     per-stage wall time and peak device memory
  pipeline/run.py    Pipeline: run() = ingest -> count (coverage guard) ->
                     graph -> paths -> raw FASTA -> summary files, with
                     resume; stage_patch
  pipeline/datasets.py  the simulated readsets the port is measured on
  convert.py         numpy <-> tensor bridges to the reference's outputs
"""

__version__ = "0.1.0"
