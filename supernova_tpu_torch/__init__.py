"""supernova_tpu_torch — the PyTorch/CUDA port of the JAX package `supernova_tpu`.

The JAX package `supernova_tpu` is the reference; this package assembles
the same genome from the same 10x FASTQs, bit for bit, with PyTorch
tensors, and replaces each Pallas TPU kernel with a hand-written CUDA C++
kernel for Hopper (sm_90a).  It never imports `jax`, nor any module of
`supernova_tpu`: the host modules it needs are its own copies, held to the
originals by tests/test_torch_hostcopies.py.

    python -m supernova_tpu_torch run --fastqs DIR --whitelist WL --out OUT [--device cuda|cpu]

runs the reference's whole pipeline (ingest, count, graph, paths, patch,
supergraph, scaffold and phase, FASTA in four flavors) on the card, or on
the CPU's plain twins with --device cpu; the other subcommands are the
reference's tools.

The command line and the pipeline runtime:
  __main__.py, cli.py  the reference's subcommands (run, simulate, evaluate,
                       diagnose, mkoutput, stats, sitecheck, bcmat, tarmri,
                       demux, mkfastq, import-ref, export-ref, readcount,
                       sam, readqa, graph-fasta, graph-stats, scaf-graph)
                       and the multi-host join from the environment
  pipeline/run.py      Pipeline: run() (raw FASTA), run_full() (every
                       output), each stage with resume; run_full's stages
                       through the orchestrator
  pipeline/orchestrate.py  pipestance.json, stage retry, StageError (copy;
                       the host rank from torch.distributed)
  pipeline/preflight.py, pipeline/datasets.py  input checks (copy); the
                       simulated readsets the port is measured on
  core/config.py       addin overrides of heuristic constants (copy)
  core/device.py       explicit device resolution (no CPU fallback)
  stats/               stage timer and profiler spans with their counters
                       (trace.py), StatLogger, histograms,
                       gems (copies); profile_slice, profile_supergraph,
                       kernel_phases (measurement scripts for the card)

The device path:
  ops/kernels/         K1 kmer_extract, K2 compact, K3 run_reduce, K4 sort,
                       K5 scan_max:
                       wrappers over csrc/*.cu (built at first use into
                       _build/, loaded with ctypes) beside their plain twins
  ops/segments.py, ops/alignment.py  run masks and stable compaction; the
                       het DP on the device
  core/kmer_codec.py   48-mer words as three int64 tensors (W3)
  kmer/count.py, kmer/spill.py  single-block and blocked count
                       (partitioned merge, spill/resume, OOM retry)
  dbg/build.py, dbg/graph.py  unipath graph build; BaseGraph (graph.npz)
  align/pather.py      fused and general pathers, blocked, OOM retry
  parallel/device_nucleate.py  the supergraph's closure glue on the device
  parallel/mesh.py, parallel/dist.py  a mesh of shards (one torch device
                       each) and its collectives; the multi-process fleet
  parallel/sharded_{count,build,path,nucleate}.py  count, graph build,
                       pather and closure glue sharded over the mesh
  asm/patch.py, asm/nucleate.py, asm/supergraph.py, asm/misassembly.py,
  asm/het.py           host copies apart from their device seams
  convert.py           numpy <-> tensor bridges to the reference's outputs

Host copies of the reference's modules:
  core dna/ragged/pqvec; ingest reads/ingest/barcodes/fastq/tenx/
  discovery/feudal/demux; native FASTQ decoder and glue core (C++); sim;
  align rescue/pathzip/index; asm bads/dups/stackster, the supergraph
  stage's modules (gap, lines, molecules, place, closures, bubbles,
  inversion, clean, pullapart, capture, local), the scaffold stage's
  (links, scaffold, star, gaprika, fillcheck, stackaroo, splat, fixint,
  barcode_join, phasing, report) and the evaluators (evaluate, astats,
  diagnose, minhash); out fasta/pseudohap/gfa/superfiles/efasta/exports/
  sam/readqa.
"""

__version__ = "0.1.0"
