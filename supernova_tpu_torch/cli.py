"""Command-line interface of the port — supernova_tpu/cli.py on PyTorch.

    python -m supernova_tpu_torch run --fastqs DIR --whitelist barcodes.txt \
        --out outdir [--device cuda|cpu] [--flavors pseudohap,...]
    python -m supernova_tpu_torch simulate --out simdir [--genome-size 20000]
    python -m supernova_tpu_torch evaluate --fasta F --truth A.npy B.npy

Every subcommand of the reference's main() takes the same arguments and
prints the same JSON with the same exit codes (0; 1 for bad input; 185
when a stage fails after its retry; 99 for host memory), with these
differences:
  * --platform is --device (top-level or after `run`), default "cuda": the
    pipeline's device stages run on the card, and without one `run` exits
    1 before any work.  There is no CPU fallback; --device cpu runs the
    plain twins, as the tests do.
  * sitecheck, the crash forensics and the .mri.tgz bundle's _sitecheck
    report torch, CUDA, each card's name and memory and nvcc on the PATH.
  * --localcores sets OMP_NUM_THREADS and torch.set_num_threads.
  * mkoutput refuses an assembly_state.pkl written by the JAX package
    (its classes name supernova_tpu modules), and imports none of it.
  * The multi-host join from the environment (SUPERNOVA_NUM_PROCESSES > 1,
    parallel/dist.py) joins a torch.distributed group after the arguments
    are parsed, with the backend of --device (gloo for cpu, NCCL for cuda).
"""
from __future__ import annotations

import argparse
import json
import pickle
import sys
from pathlib import Path

import numpy as np


def cmd_run(args) -> int:
    from .core.device import resolve_device
    from .ingest.tenx import ingest_10x_fastqs, load_whitelist
    from .pipeline.preflight import preflight

    try:
        args.device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if getattr(args, "addin", None):
        # heuristic-constant overrides (the reference's addin map,
        # df/__init__.py:138-139; see core/config.py)
        from .core.config import apply_addins, parse_addin_args

        applied = apply_addins(parse_addin_args(args.addin))
        for k, v in parse_addin_args(args.addin).items():
            print(f"addin: {k} = {v} (was {applied[k]})", file=sys.stderr)

    if getattr(args, "resume", False):
        # resume: the ingest checkpoint supersedes FASTQ re-ingest (the
        # reads stages' chunk outputs in the reference pipestance)
        ck = Path(args.out) / "reads.npz"
        if ck.exists():
            from .ingest.reads import ReadSet

            print(f"resume: loading ingest checkpoint {ck}", file=sys.stderr)
            rs = ReadSet.load(ck)
            return _run_pipeline(args, rs)
    interleaved = False
    if getattr(args, "reads", None):
        # pre-ingested ReadSet (reads.npz — e.g. from import-ref): skip
        # FASTQ discovery/preflight/ingest entirely
        from .ingest.reads import ReadSet

        rs = ReadSet.load(args.reads)
        return _run_pipeline(args, rs)
    if getattr(args, "fastqs", None):
        # directory discovery (tenkit find_input_fastqs; ingest/discovery.py)
        from .ingest.discovery import discover_input_fastqs

        try:
            d = discover_input_fastqs(
                args.fastqs, sample=getattr(args, "sample", None),
                lanes=getattr(args, "lanes", None),
            )
        except (ValueError, FileNotFoundError) as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        args.r1, args.r2 = d["r1"], d["r2"]
        interleaved = d["interleaved"]
        print(
            f"discovered {len(args.r1)} {d['mode']} FASTQ file(s)",
            file=sys.stderr,
        )
    elif not (args.r1 and args.r2):
        print("ERROR: pass --r1/--r2, --fastqs DIR, or --reads NPZ",
              file=sys.stderr)
        return 1
    if not args.whitelist:
        print("ERROR: --whitelist is required for FASTQ ingest",
              file=sys.stderr)
        return 1

    wl = load_whitelist(args.whitelist)
    pf = preflight(args.r1, args.r2 if not interleaved else args.r1, len(wl))
    for w in pf.warnings:
        print(f"WARNING: {w}", file=sys.stderr)
    if not pf.ok:
        for e in pf.errors:
            print(f"ERROR: {e}", file=sys.stderr)
        return 1

    rs = ingest_10x_fastqs(
        args.r1, args.r2, wl, max_pairs=args.max_pairs,
        interleaved=interleaved,
    )
    return _run_pipeline(args, rs)


def _run_pipeline(args, rs) -> int:
    from .pipeline.run import Pipeline

    ds = None
    if getattr(args, "downsample_reads", None):
        ds = {"target_reads": args.downsample_reads}
    elif getattr(args, "downsample_gb", None):
        ds = {"gigabases": args.downsample_gb}
    pl = Pipeline(args.out, device=args.device, downsample=ds,
                  resume=getattr(args, "resume", False))
    for key in ("description", "localcores", "localmem"):
        if getattr(args, key, None) is not None:
            pl.stats.log(key, getattr(args, key), stage="ingest")
    flavors = tuple(args.flavors.split(","))
    cmdline = " ".join(sys.argv)
    try:
        pl.run_full(rs, flavors=flavors)
    except RuntimeError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        make_mri_bundle(args.out, ecode=185, cmdline=cmdline)
        return 185  # controlled exit, like Martian::exit (Martian.h:13)
    except MemoryError:
        _crash_forensics(args.out)
        make_mri_bundle(args.out, ecode=99, cmdline=cmdline)
        print(
            "ERROR: out of memory — rerun with --downsample-reads or on a "
            "larger host (reference exit code 99 semantics)",
            file=sys.stderr,
        )
        return 99
    except Exception:
        _crash_forensics(args.out)
        make_mri_bundle(args.out, ecode=1, cmdline=cmdline)
        raise
    make_mri_bundle(args.out, ecode=0, cmdline=cmdline)
    print(json.dumps(json.loads((Path(args.out) / "summary.json").read_text()), indent=1))
    return 0


def _crash_forensics(outdir) -> None:
    """On stage failure, record host/device state for postmortem — the
    reference logs dmesg + top-RSS ps on non-zero stage returns
    (mro/stages/denovo/df/__init__.py:30-90)."""
    import datetime
    import platform
    import subprocess

    lines = [f"crash forensics @ {datetime.datetime.now().isoformat()}"]
    lines.append(f"host: {platform.node()} {platform.platform()}")
    try:
        mem = Path("/proc/meminfo").read_text().splitlines()[:4]
        lines += [f"meminfo: {m}" for m in mem]
    except Exception:
        pass
    try:
        ps = subprocess.run(
            ["ps", "--sort=-rss", "-eo", "pid,pmem,rss,comm"],
            capture_output=True, text=True, timeout=10,
        ).stdout.splitlines()[:7]
        lines += ps
    except Exception:
        pass
    lines += [f"{k}: {v}" for k, v in _torch_info().items()]
    try:
        p = Path(outdir)
        p.mkdir(parents=True, exist_ok=True)
        (p / "crash_forensics.log").write_text("\n".join(lines) + "\n")
    except Exception:
        pass
    for line in lines:
        print(line, file=sys.stderr)


def cmd_sitecheck(args) -> int:
    """Environment diagnostics — the reference's `supernova sitecheck`
    (tenkit/bin/sitecheck)."""
    print(json.dumps(_sitecheck_info(), indent=1))
    return 0


def _sitecheck_info() -> dict:
    import platform
    import shutil as sh

    info = {
        "host": platform.node(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "cpus": __import__("os").cpu_count(),
    }
    try:
        mem = Path("/proc/meminfo").read_text().splitlines()
        info["mem_total"] = mem[0].split()[1] + " kB"
    except Exception:
        pass
    try:
        du = sh.disk_usage(".")
        info["disk_free_gb"] = round(du.free / 2**30, 1)
    except Exception:
        pass
    info["numpy_version"] = np.__version__
    info.update(_torch_info())
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        info["open_fd_limit"] = [soft, hard]
    except Exception:
        pass
    return info


def _torch_info() -> dict:
    """torch's and CUDA's versions, each card's name and total memory, and
    the nvcc on the PATH (None where there is none); never raises."""
    import shutil as sh

    info = {}
    try:
        import torch

        info["torch_version"] = torch.__version__
        info["cuda_version"] = torch.version.cuda
        info["cuda_devices"] = [
            {"name": torch.cuda.get_device_name(i),
             "total_memory_gb": round(torch.cuda.get_device_properties(i).total_memory / 2**30, 2)}
            for i in range(torch.cuda.device_count())
        ]
    except Exception as e:
        info["torch_error"] = str(e)
    info["nvcc_on_path"] = sh.which("nvcc")
    return info


def make_mri_bundle(outdir, ecode: int = 0, cmdline: str = "") -> "Path | None":
    """Bundle run diagnostics into <outdir>/<name>.mri.tgz — the
    reference's `tarmri` (tenkit/bin/tarmri): captures _cmdline,
    _sitecheck and _filelist into the run dir, then tars every small
    (<1 MB) text/JSON artifact, skipping the bulk data payloads."""
    import tarfile

    outdir = Path(outdir)
    if not outdir.is_dir():
        return None
    (outdir / "_cmdline").write_text(cmdline + "\n")
    (outdir / "_sitecheck").write_text(json.dumps(_sitecheck_info(), indent=1))
    entries = sorted(p for p in outdir.rglob("*") if p.is_file())
    (outdir / "_filelist").write_text(
        "".join(f"{p.stat().st_size}\t{p.relative_to(outdir)}\n"
                for p in entries)
    )
    bundle = outdir / (outdir.name + ".mri.tgz")
    skip_suffixes = {".npz", ".npy", ".gz", ".pkl", ".tgz", ".mm"}
    always = {"summary.json", "summary_cs.csv", "all_stats.json",
              "alerts.json", "pipestance.json"}
    with tarfile.open(bundle, "w:gz") as tf:
        for p in sorted(outdir.rglob("*")):
            if not p.is_file() or p == bundle:
                continue
            if p.name not in always and (
                    p.suffix in skip_suffixes or p.stat().st_size >= 1 << 20):
                continue
            tf.add(p, arcname=str(p.relative_to(outdir)))
    if ecode != 0:
        print(f"Saved diagnostics to {bundle} — attach it when reporting "
              "this failure.", file=sys.stderr)
    return bundle


def cmd_tarmri(args) -> int:
    """Standalone diagnostics bundler (`tarmri` analogue)."""
    b = make_mri_bundle(args.dir, ecode=args.ecode,
                        cmdline=" ".join(sys.argv))
    if b is None:
        print(f"ERROR: {args.dir} is not a directory", file=sys.stderr)
        return 1
    print(json.dumps({"bundle": str(b), "bytes": b.stat().st_size}))
    return 0


def cmd_sam(args) -> int:
    """Export read->graph placements as SAM (the _ALIGNER/BAM QA analogue;
    see out/sam.py)."""
    from .out.sam import export_sam_from_run

    n = export_sam_from_run(args.dir, args.out, sample=args.sample)
    print(json.dumps({"sam": args.out, "records": n}))
    return 0


def cmd_readqa(args) -> int:
    """_ALIGNER-equivalent read QA against the assembly (out/readqa.py)."""
    from .out.readqa import write_readqa

    paths = write_readqa(
        args.dir, qa_dir=args.out, whitelist_path=args.whitelist,
        whitelist_name=args.whitelist_name,
    )
    print(json.dumps(paths))
    return 0


def simulate_sample(args):
    """The linked reads `simulate` writes, from its arguments -> (SimReads,
    whitelist codes, haplotype a, haplotype b)."""
    from .sim import genome as sim

    rng = np.random.default_rng(args.seed)
    g = sim.random_genome(rng, args.genome_size, n_repeat_chunks=args.repeats)
    _, hb = sim.diploidize(rng, g, het_rate=args.het_rate)
    # the whitelist must be at least as large as the barcode draw
    # (sim samples barcodes without replacement, mirroring the reference's
    # 4M-barcode whitelist being far larger than any run's GEM count)
    wl_size = max(args.whitelist_size, 2 * args.barcodes)
    wl = sim.make_whitelist(rng, wl_size)
    # Chromium-realistic GEM statistics (alarms-supernova.json:100-112):
    # ~10 molecules/barcode, exponential molecule lengths mean ~60 kb,
    # 0.2x per-molecule read sampling.  Per-barcode yield 10*60k*0.2 =
    # 120 kb matches the previous dense model (3*20k*2.0), so the ladder
    # scripts' --barcodes counts keep their ~48x total coverage.
    reads = sim.simulate_linked_reads(
        rng,
        (g, hb),
        wl,
        n_barcodes=args.barcodes,
        molecules_per_barcode=args.molecules_per_barcode,
        molecule_len=min(args.molecule_len, max(args.genome_size // 2, 2_000)),
        coverage_per_molecule=args.mol_coverage,
        error_rate=args.error_rate,
        bc_error_rate=0.01,
        chromium_model=not args.dense_sim,
    )
    return reads, wl, g, hb


def write_sample_truth(out: Path, wl, g, hb) -> Path:
    """`simulate`'s whitelist.txt and truth_hap_{a,b}.npy in out -> the
    whitelist's path."""
    from .core import dna

    wl_path = out / "whitelist.txt"
    wl_path.write_text("\n".join(dna.codes_to_seq(b) for b in wl) + "\n")
    np.save(out / "truth_hap_a.npy", g)
    np.save(out / "truth_hap_b.npy", hb)
    return wl_path


def cmd_simulate(args) -> int:
    from .ingest.tenx import write_sim_fastqs

    reads, wl, g, hb = simulate_sample(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    r1, r2 = write_sim_fastqs(reads, out)
    wl_path = write_sample_truth(out, wl, g, hb)
    print(json.dumps({"r1": str(r1), "r2": str(r2), "whitelist": str(wl_path),
                      "n_pairs": reads.n_pairs()}))
    return 0


def cmd_evaluate(args) -> int:
    """Evaluate an assembly FASTA against truth haplotype .npy files
    (astats analogue; pairs with `simulate` outputs)."""
    from .asm.evaluate import evaluate_assembly
    from .core import dna
    from .out.fasta import read_fasta

    contigs, scaffolds = [], []
    for _, seq in read_fasta(args.fasta):
        scaffolds.append(dna.seq_to_codes(seq, n_as=4))
        for part in seq.split("N"):
            if len(part) >= args.min_len:
                contigs.append(dna.seq_to_codes(part))
    haps = [np.load(p) for p in args.truth]
    res = evaluate_assembly(contigs, haps)
    # scaffold-level dis/ori/ord misassembly decomposition + gap accuracy
    # (astats/Misassembly.cc + MeasureGaps.cc analogues)
    from .asm.astats import evaluate_scaffolds

    res.update(evaluate_scaffolds(scaffolds, haps))
    print(json.dumps(res, indent=1))
    return 0


def cmd_diagnose(args) -> int:
    """Attribute flagged misassemblies to their creating stage
    (asm/diagnose.py)."""
    from .asm.diagnose import diagnose_assembly, summarize

    diags = diagnose_assembly(
        args.fasta, args.truth, args.dir, min_len=args.min_len
    )
    for d in diags:
        print(f"{d.name} len={d.length}")
        for b in d.breaks:
            print(
                f"  break@{b.pos} {b.left} -> {b.right} "
                f"sep={b.separation} provenance={b.provenance}"
            )
    print(json.dumps({"breaks": summarize(diags),
                      "flagged_contigs": len(diags)}))
    return 0


class _PortUnpickler(pickle.Unpickler):
    """Refuses every class of the JAX package, so that loading a pickle the
    reference wrote never imports it."""

    def find_class(self, module, name):
        if module.split(".")[0] == "supernova_tpu":
            raise pickle.UnpicklingError(f"it names {module}.{name}")
        return super().find_class(module, name)


def cmd_mkoutput(args) -> int:
    """Re-emit FASTA flavors from a finished run (the reference's standalone
    `supernova mkoutput` / MakeFasta binary, 10X/tools/MakeFasta.cc)."""
    from .out import fasta as fout
    from .out import pseudohap as oph

    state_p = Path(args.dir) / "assembly_state.pkl"
    if not state_p.exists():
        print(f"ERROR: {state_p} not found (run the pipeline first)", file=sys.stderr)
        return 1
    try:
        with open(state_p, "rb") as f:
            st = _PortUnpickler(f).load()
    except pickle.UnpicklingError as e:
        print(f"ERROR: {state_p} was written by the JAX package ({e}); re-emit it "
              "with `python -m supernova_tpu mkoutput`, or rerun the assembly with "
              "this package", file=sys.stderr)
        return 1
    D, lines, scaffolds, phasings = (
        st["D"], st["lines"], st["scaffolds"], st["phasings"]
    )
    outdir = Path(args.out or args.dir)
    outdir.mkdir(parents=True, exist_ok=True)
    for flavor in args.flavors.split(","):
        out = outdir / f"assembly.{flavor}.fasta.gz"
        if flavor == "raw":
            fout.write_raw_fasta(D.bg, out)
        elif flavor == "megabubbles":
            oph.write_megabubbles_fasta(D, lines, scaffolds, phasings, out)
        elif flavor == "pseudohap":
            oph.write_pseudohap_fasta(D, lines, scaffolds, phasings, out)
        elif flavor == "pseudohap2":
            oph.write_pseudohap2_fasta(D, lines, scaffolds, phasings, out)
        elif flavor == "efasta":
            from .out import efasta as oef

            out = outdir / "assembly.efasta.gz"
            oef.write_efasta(D, lines, scaffolds, phasings, out)
        else:
            print(f"ERROR: unknown flavor {flavor}", file=sys.stderr)
            return 1
        print(str(out))
    return 0


def cmd_stats(args) -> int:
    """Graph statistics from a graph checkpoint (`tada stats` analogue)."""
    from .dbg.graph import BaseGraph
    from .stats.logger import n50

    bg = BaseGraph.load(args.graph)
    lens = bg.edges.lengths()
    canon = np.arange(bg.n_edges) <= bg.inv
    out = {
        "n_edges": int(bg.n_edges),
        "n_vertices": int(bg.n_vertices),
        "edge_N50": int(n50(lens[canon])),
        "total_bases": int(lens[canon].sum()),
        "total_kmers": int(bg.total_kmers() // 2),
        "n_circles": int(np.asarray(bg.is_circle).sum()),
        "checksum": bg.checksum(),
    }
    print(json.dumps(out, indent=1))
    return 0


def cmd_bcmat(args) -> int:
    """Export the edge->barcode incidence matrix (`tada bcmat` analogue,
    cmd_graph_stats.rs:89) from a run directory's ebcx checkpoint."""
    from .core.ragged import Ragged
    from .out.exports import write_bcmat

    z = np.load(Path(args.dir) / "ebcx.npz")
    ebcx = Ragged(z["values"], z["offsets"])
    out = write_bcmat(ebcx, args.out, comment=f"run dir: {args.dir}")
    print(json.dumps({"out": str(out), "n_edges": ebcx.n_rows,
                      "nnz": int(len(ebcx.values))}))
    return 0


def cmd_demux(args) -> int:
    """Sample-index demultiplexing of basecalled FASTQs (the BCL_PROCESSOR
    demultiplex stage, tenkit/mro/stages/bcl_processor/demultiplex)."""
    from .ingest.demux import demultiplex

    reads = {}
    for spec in args.reads:
        rt, _, path = spec.partition("=")
        if not path:
            print(f"ERROR: --reads wants TYPE=PATH, got {spec!r}", file=sys.stderr)
            return 1
        reads[rt] = path
    summary = demultiplex(
        args.si, reads, args.out,
        indexes=args.indexes.split(",") if args.indexes else None,
        lane=args.lane,
    )
    print(json.dumps({"out": args.out, "indexes": summary}))
    return 0


def cmd_mkfastq(args) -> int:
    """BCL run folder -> demultiplexed FASTQs (`supernova mkfastq`).  Raw
    BCL basecalling needs Illumina's bcl2fastq, which this image lacks —
    detect the run folder and say so; basecalled FASTQs go through demux."""
    run = Path(args.run)
    if (run / "RunInfo.xml").exists() or (run / "Data" / "Intensities").exists():
        print(
            "ERROR: raw Illumina BCL decoding requires bcl2fastq (not in "
            "this environment). Basecall the run first, then use "
            "`supernova_tpu_torch demux --si <I1.fastq.gz> --reads "
            "R1=<R1> R2=<R2> --out <dir>`.",
            file=sys.stderr,
        )
        return 1
    print(f"ERROR: {run} does not look like an Illumina run folder "
          "(no RunInfo.xml)", file=sys.stderr)
    return 1


def cmd_import_ref(args) -> int:
    """Reference intermediates -> reads.npz: read the feudal fastb/qualp +
    BINWRITE bci triple the reference's ParseBarcodedFastqs emits
    (10X/ParseBarcodedFastqs.cc:174-234; ingest/feudal.py has the formats).
    The result runs directly: `run --reads OUT/reads.npz`."""
    from pathlib import Path

    from .ingest import feudal
    from .ingest.reads import ReadSet

    bases = feudal.read_fastb(args.fastb)
    n = bases.n_rows
    if args.qualp:
        q = feudal.read_qualp(args.qualp)
        if q.n_rows != n or not np.array_equal(q.offsets, bases.offsets):
            print("ERROR: qualp disagrees with fastb lengths", file=sys.stderr)
            return 1
        quals = q.values
    else:
        quals = np.full(len(bases.values), 37, np.uint8)
    if args.bci:
        bci = feudal.read_bci(args.bci).astype(np.int64)
        if bci[0] != 0 or bci[-1] != n or (np.diff(bci) < 0).any():
            print("ERROR: bad bci (not a CSR over the reads)", file=sys.stderr)
            return 1
        bc = np.repeat(
            np.arange(len(bci) - 1, dtype=np.int32), np.diff(bci)
        )
        barcoded = len(bci) > 2
    else:
        bci = np.array([0, n], np.int64)
        bc = np.zeros(n, np.int32)
        barcoded = False
    rs = ReadSet(
        codes=bases.values, offsets=bases.offsets, quals=quals, bc=bc,
        bci=bci, barcoded=barcoded,
    )
    rs.validate()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rs.save(out / "reads.npz")
    print(json.dumps({
        "n_reads": rs.n_reads, "n_bases": int(rs.offsets[-1]),
        "n_barcodes": rs.n_barcodes, "out": str(out / "reads.npz"),
    }))
    return 0


def cmd_export_ref(args) -> int:
    """reads.npz -> reference-format fastb/qualp/bci (and, with --graph,
    the unipath edges as a BINWRITE vec<basevector> like tada's asm_graph,
    debruijn.rs:885-930)."""
    from pathlib import Path

    from .core.ragged import Ragged
    from .ingest import feudal
    from .ingest.reads import ReadSet

    d = Path(args.dir)
    head = Path(args.out_head)
    head.parent.mkdir(parents=True, exist_ok=True)
    rs = ReadSet.load(d / "reads.npz")
    feudal.write_fastb(str(head) + ".fastb", Ragged(rs.codes, rs.offsets))
    feudal.write_qualp(str(head) + ".qualp", Ragged(rs.quals, rs.offsets))
    feudal.write_bci(str(head) + ".bci", rs.bci.astype(np.int64))
    written = [str(head) + s for s in (".fastb", ".qualp", ".bci")]
    if args.graph and (d / "graph.npz").exists():
        from .dbg.graph import BaseGraph

        bg = BaseGraph.load(d / "graph.npz")
        feudal.write_bvecs(str(head) + ".asm_graph.bv", bg.edges)
        written.append(str(head) + ".asm_graph.bv")
    print(json.dumps({"written": written}))
    return 0


def cmd_readcount(args) -> int:
    """Print the read count of a reads.npz checkpoint — the reference's
    FastFastbCount utility (10X/FastFastbCount.cc, used by the DF stage's
    downsampling split, mro/stages/denovo/df/__init__.py:25-27)."""
    z = np.load(args.reads)
    n = int(len(z["offsets"]) - 1)
    print(json.dumps({"n_reads": n, "n_bases": int(z["offsets"][-1])}))
    return 0


def cmd_graph_stats(args) -> int:
    """Per-edge TSV export (`tada stats` analogue, cmd_graph_stats.rs:29)."""
    from .core.ragged import Ragged
    from .dbg.graph import BaseGraph
    from .out.exports import write_graph_stats

    bg = BaseGraph.load(Path(args.dir) / "graph.npz")
    ebcx = None
    ep = Path(args.dir) / "ebcx.npz"
    if ep.exists():
        z = np.load(ep)
        ebcx = Ragged(z["values"], z["offsets"])
    out = write_graph_stats(bg, ebcx, args.out)
    print(json.dumps({"out": str(out), "n_edges": bg.n_edges}))
    return 0


def cmd_graph_fasta(args) -> int:
    """Dump the unipath graph's edges as FASTA (`tada fasta` analogue,
    lib/tada/src/main.rs graph export commands): one record per canonical
    edge (id, length, kmers in the header)."""
    import gzip as _gz

    from .core import dna
    from .dbg.graph import BaseGraph

    bg = BaseGraph.load(Path(args.dir) / ("graph.patched.npz" if (
        Path(args.dir) / "graph.patched.npz").exists() and args.patched
        else "graph.npz"))
    from .core.kmer_codec import K as KK

    op = args.out
    f = _gz.open(op, "wt") if str(op).endswith(".gz") else open(op, "w")
    n = 0
    with f:
        for e in range(bg.n_edges):
            if e > int(bg.inv[e]):
                continue  # one record per rc pair
            s = bg.edge_seq(e)
            f.write(f">edge_{e} len={len(s)} kmers={len(s) - KK + 1} "
                    f"inv={int(bg.inv[e])}\n")
            for i in range(0, len(s), 80):
                f.write(s[i : i + 80] + "\n")
            n += 1
    print(json.dumps({"out": str(op), "records": n}))
    return 0


def cmd_scaf_graph(args) -> int:
    """Barcode-overlap contig proximity graph (`tada scaf-graph` analogue,
    scaf_graph.rs:84-97)."""
    from .core.ragged import Ragged
    from .dbg.graph import BaseGraph
    from .out.exports import write_scaf_graph

    bg = BaseGraph.load(Path(args.dir) / "graph.npz")
    z = np.load(Path(args.dir) / "ebcx.npz")
    ebcx = Ragged(z["values"], z["offsets"])
    out = write_scaf_graph(
        bg.edges.lengths(), ebcx, args.out,
        min_ctg=args.min_ctg, min_bcs=args.min_bcs, max_bcs=args.max_bcs,
    )
    n = sum(1 for _ in open(out))
    print(json.dumps({"out": str(out), "n_links": n}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The command line's parser: every subcommand and its arguments."""
    ap = argparse.ArgumentParser(prog="supernova_tpu_torch")
    ap.add_argument(
        "--device", default="cuda",
        help="where run's device stages go: cuda (the default; exits 1 "
             "without a card, no CPU fallback), cuda:N or cpu",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="assemble 10x linked-read FASTQs")
    r.add_argument("--r1", nargs="+", default=None)
    r.add_argument("--r2", nargs="+", default=None)
    r.add_argument("--fastqs", default=None,
                   help="discover FASTQs in this directory (bcl2fastq or "
                        "BCL_PROCESSOR naming; tenkit find_input_fastqs)")
    r.add_argument("--sample", default=None,
                   help="sample prefix / sample-index filter for --fastqs")
    r.add_argument("--lanes", nargs="+", type=int, default=None)
    r.add_argument("--localcores", type=int, default=None,
                   help="host thread cap (reference --localcores)")
    r.add_argument("--localmem", type=int, default=None,
                   help="advisory host memory cap in GB (recorded; the "
                        "blocked count already bounds device memory)")
    r.add_argument("--description", default=None,
                   help="free-text run description (recorded in stats)")
    r.add_argument("--whitelist", default=None,
                   help="barcode whitelist (required unless --reads)")
    r.add_argument("--reads", default=None,
                   help="pre-ingested reads.npz (e.g. from import-ref); "
                        "skips FASTQ ingest")
    r.add_argument("--out", required=True)
    r.add_argument("--flavors", default="raw,megabubbles,pseudohap,pseudohap2")
    r.add_argument("--max-pairs", type=int, default=None)
    r.add_argument("--downsample-reads", type=int, default=None,
                   help="downsample to this many reads (reference's target_reads)")
    r.add_argument("--addin", action="append", default=None,
                   metavar="PATH=VALUE",
                   help="override a heuristic constant, e.g. "
                        "asm.star.MIN_ADVANTAGE=40 (repeatable; the "
                        "reference's addin map)")
    r.add_argument("--downsample-gb", type=float, default=None,
                   help="downsample to this many gigabases")
    r.add_argument("--resume", action="store_true",
                   help="reuse stage checkpoints in --out (START=x re-entry)")
    r.add_argument("--device", default=argparse.SUPPRESS,
                   help="as the top-level --device")
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("simulate", help="generate a synthetic linked-read dataset")
    s.add_argument("--out", required=True)
    s.add_argument("--genome-size", type=int, default=20_000)
    s.add_argument("--repeats", type=int, default=2)
    s.add_argument("--het-rate", type=float, default=0.001)
    s.add_argument("--error-rate", type=float, default=0.002,
                   help="per-base substitution rate (real Illumina ~0.1-1.5%%)")
    s.add_argument("--barcodes", type=int, default=100)
    s.add_argument("--whitelist-size", type=int, default=512)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--molecules-per-barcode", type=int, default=10,
                   help="mean molecules per GEM (Poisson; chromium model)")
    s.add_argument("--molecule-len", type=int, default=60_000,
                   help="mean molecule length (exponential; chromium model)")
    s.add_argument("--mol-coverage", type=float, default=0.2,
                   help="per-molecule read coverage (reference: 0.1-0.3x)")
    s.add_argument("--dense-sim", action="store_true",
                   help="legacy dense model: fixed-length molecules, no "
                        "Poisson GEM loading (pre-round-4 rungs)")
    s.set_defaults(fn=cmd_simulate)

    e = sub.add_parser("evaluate", help="evaluate an assembly vs truth haplotypes")
    e.add_argument("--fasta", required=True)
    e.add_argument("--truth", nargs="+", required=True, help=".npy code arrays")
    e.add_argument("--min-len", type=int, default=300)
    e.set_defaults(fn=cmd_evaluate)

    dg = sub.add_parser(
        "diagnose",
        help="attribute flagged misassemblies to the pipeline decision "
             "that created them (breakpoints + checkpoint provenance)",
    )
    dg.add_argument("--fasta", required=True)
    dg.add_argument("--truth", nargs="+", required=True)
    dg.add_argument("--dir", default=None,
                    help="pipeline outdir for provenance classification")
    dg.add_argument("--min-len", type=int, default=400)
    dg.set_defaults(fn=cmd_diagnose)

    mo = sub.add_parser("mkoutput", help="re-emit FASTA flavors from a finished run")
    mo.add_argument("--dir", required=True, help="pipeline output directory")
    mo.add_argument("--out", default=None, help="destination (default: --dir)")
    mo.add_argument("--flavors", default="pseudohap")
    mo.set_defaults(fn=cmd_mkoutput)

    st = sub.add_parser("stats", help="graph statistics from a checkpoint")
    st.add_argument("--graph", required=True)
    st.set_defaults(fn=cmd_stats)

    sc = sub.add_parser("sitecheck", help="environment diagnostics")
    sc.set_defaults(fn=cmd_sitecheck)

    bm = sub.add_parser("bcmat", help="export edge->barcode MatrixMarket matrix")
    bm.add_argument("--dir", required=True, help="run directory (has ebcx.npz)")
    bm.add_argument("--out", required=True)
    bm.set_defaults(fn=cmd_bcmat)

    tm = sub.add_parser("tarmri", help="bundle run diagnostics into .mri.tgz")
    tm.add_argument("--dir", required=True, help="run directory")
    tm.add_argument("--ecode", type=int, default=0)
    tm.set_defaults(fn=cmd_tarmri)

    dx = sub.add_parser("demux", help="demultiplex FASTQs by sample index")
    dx.add_argument("--si", required=True, help="sample-index (I1) fastq[.gz]")
    dx.add_argument("--reads", nargs="+", required=True,
                    help="TYPE=PATH pairs (e.g. R1=a.fq.gz R2=b.fq.gz)")
    dx.add_argument("--out", required=True)
    dx.add_argument("--indexes", default=None,
                    help="comma-separated SI seqs (default: auto-discover)")
    dx.add_argument("--lane", type=int, default=1)
    dx.set_defaults(fn=cmd_demux)

    mf = sub.add_parser("mkfastq", help="BCL run folder -> FASTQs (gated)")
    mf.add_argument("--run", required=True)
    mf.set_defaults(fn=cmd_mkfastq)

    ir = sub.add_parser(
        "import-ref",
        help="reference fastb/qualp/bci intermediates -> reads.npz",
    )
    ir.add_argument("--fastb", required=True)
    ir.add_argument("--qualp", default=None)
    ir.add_argument("--bci", default=None)
    ir.add_argument("--out", required=True, help="output directory")
    ir.set_defaults(fn=cmd_import_ref)

    er = sub.add_parser(
        "export-ref",
        help="reads.npz (+ graph) -> reference fastb/qualp/bci formats",
    )
    er.add_argument("--dir", required=True, help="run directory")
    er.add_argument("--out-head", required=True,
                    help="output path head (e.g. out/frag_reads_orig)")
    er.add_argument("--graph", action="store_true",
                    help="also write the unipath graph as BINWRITE bv")
    er.set_defaults(fn=cmd_export_ref)

    rc = sub.add_parser("readcount", help="read count of a reads.npz (FastFastbCount)")
    rc.add_argument("--reads", required=True)
    rc.set_defaults(fn=cmd_readcount)

    sm = sub.add_parser(
        "sam", help="export read placements as SAM (BX tags; _ALIGNER QA analogue)"
    )
    sm.add_argument("--dir", required=True, help="finished run directory")
    sm.add_argument("--out", required=True, help="output .sam or .sam.gz")
    sm.add_argument("--sample", default="sample")
    sm.set_defaults(fn=cmd_sam)

    rq = sub.add_parser(
        "readqa",
        help="read-QA report: duplicate_summary/lot_info/readqa jsons "
             "(the _ALIGNER QA products against the assembly; out/readqa.py)",
    )
    rq.add_argument("--dir", required=True, help="finished run directory")
    rq.add_argument("--out", default=None,
                    help="QA output dir (default: run dir)")
    rq.add_argument("--whitelist", default=None,
                    help="barcode whitelist file (enables lot detection)")
    rq.add_argument("--whitelist-name", default=None,
                    help="canonical whitelist name for lot oligo lookup "
                         "(e.g. 4M-with-alts-february-2016)")
    rq.set_defaults(fn=cmd_readqa)

    gf = sub.add_parser("graph-fasta", help="unipath edges as FASTA (tada fasta)")
    gf.add_argument("--dir", required=True)
    gf.add_argument("--out", required=True)
    gf.add_argument("--patched", action="store_true",
                    help="use graph.patched.npz when present")
    gf.set_defaults(fn=cmd_graph_fasta)

    gs = sub.add_parser("graph-stats", help="per-edge TSV (len/bcs/degree/seq)")
    gs.add_argument("--dir", required=True, help="run directory (has graph.npz)")
    gs.add_argument("--out", required=True)
    gs.set_defaults(fn=cmd_graph_stats)

    sg = sub.add_parser("scaf-graph", help="barcode-overlap contig graph CSV")
    sg.add_argument("--dir", required=True, help="run directory")
    sg.add_argument("--out", required=True)
    sg.add_argument("--min-ctg", type=int, default=500)
    sg.add_argument("--min-bcs", type=int, default=2)
    sg.add_argument("--max-bcs", type=int, default=5000)
    sg.set_defaults(fn=cmd_scaf_graph)
    return ap


def main(argv=None) -> int:
    # stage progress (STAGE x: begin/done lines) goes to stderr — the
    # reference's Date()-stamped cout tracing (SURVEY §5.1)
    import logging

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    # kill -USR1 <pid> dumps all thread stacks to stderr — the cheap
    # where-is-it-stuck probe for host-stage walls on long runs
    try:
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (ImportError, AttributeError, ValueError):
        pass
    ap = build_parser()
    args = ap.parse_args(argv)
    # multi-host fleet: join before any device work when the SUPERNOVA_*
    # process environment is set (the mrp/SGE cluster-mode analogue, one
    # process per host, collectives over the ("host","chip") mesh)
    import os

    if int(os.environ.get("SUPERNOVA_NUM_PROCESSES", "1")) > 1:
        import torch.distributed as dist

        from .parallel.dist import init_from_env, local_shards

        init_from_env(args.device)
        logging.getLogger("supernova_tpu_torch").info(
            "multi-host: process %d/%d, %d local shards", dist.get_rank(),
            dist.get_world_size(), local_shards(args.device))
    if getattr(args, "localcores", None):
        # host-thread cap (the reference's --localcores): torch's intra-op
        # pool now, OpenMP pools started later; BLAS pools bound at numpy
        # import may keep their size — set OMP_NUM_THREADS in the shell
        # for a hard cap.
        import torch

        if os.environ.get("OMP_NUM_THREADS") not in (
            None, str(args.localcores),
        ):
            print(
                "WARNING: OMP_NUM_THREADS already set; --localcores "
                "overrides it for this process", file=sys.stderr,
            )
        os.environ["OMP_NUM_THREADS"] = str(args.localcores)
        torch.set_num_threads(args.localcores)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
