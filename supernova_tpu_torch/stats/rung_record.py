"""A rung's assembly record: what an outdir of `run` and its `evaluate`
say, less what depends on the host's clock or memory, as one JSON object
that two runs of the same reads can be held to key by key.

    python -m supernova_tpu_torch.stats.rung_record record --run DIR/run --eval DIR/eval.json \\
        --sim-json DIR/sim.json --commit SHA --command "..." [--command "..."] \\
        --out supernova_tpu_torch/stats/rung_records/NAME.json
    python -m supernova_tpu_torch.stats.rung_record digests DIR/run > digests.json

reads an outdir written by either package's `run --flavors raw,pseudohap`
(file formats only: it imports no jax and nothing of supernova_tpu) and
writes its record: summary.json, alerts.json and all_stats.json less the
timing and memory keys (etime_*, mem_peak_*, and mem_per_read, the host's
available memory a read), evaluate's dict, every stats/histogram_*.json,
scaffold_mode ("legacy" where the run logged none) and the scaffold joins,
each FASTA flavor's records, bases and the sha256 of its uncompressed
text, assembly_checksum, the pairs simulated and the count's kmers.  The
rung (stats/rung.py) builds the same record from its own outdir and
compares the two with flatten() and compare().  `digests` gives the
sha256 of every array of an outdir's checkpoints (kmers.npz, graph.npz,
paths.npz, graph.patched.npz, cpaths.npz, dpaths.npz, supergraph.npz and
each scaffold phase's <phase>/a.sup.npz), so that two runs' first
differing stage can be found without their files side by side.
"""
from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import sys
from pathlib import Path

RECORDS = Path(__file__).with_name("rung_records")
# keys of all_stats.json / summary.json that measure the host, not the assembly
HOST_PREFIXES = ("etime_", "mem_peak_")
HOST_KEYS = ("mem_per_read",)
FLAVORS = ("raw", "pseudohap")
# a value longer than this (as JSON) is shown by its digest in a compare line
SHORT_JSON = 120


def assembly_keys(stats: dict) -> dict:
    """stats less its timing and host-memory keys."""
    return {k: v for k, v in stats.items()
            if not k.startswith(HOST_PREFIXES) and k not in HOST_KEYS}


def fasta_digest(path) -> dict:
    """A gzipped FASTA's records, bases and the sha256 of its text (gzip's
    header holds a time, so the compressed bytes of equal files differ)."""
    h, records, bases = hashlib.sha256(), 0, 0
    with gzip.open(path, "rb") as f:
        for line in f:
            h.update(line)
            if line.startswith(b">"):
                records += 1
            else:
                bases += len(line.rstrip(b"\n"))
    return dict(records=records, bases=bases, sha256=h.hexdigest())


def load_eval(path) -> dict:
    """evaluate's dict from its printed output: the JSON object from the
    first line that is "{" alone (a log line may come before it)."""
    lines = Path(path).read_text().splitlines()
    start = lines.index("{")
    return json.loads("\n".join(lines[start:]))


def assembly_record(rundir, eval_dict: dict | None = None, pairs: int | None = None,
                    flavors=FLAVORS) -> dict:
    """The record of a `run` outdir (and of its evaluate, where given)."""
    rundir = Path(rundir)
    stats = json.loads((rundir / "all_stats.json").read_text())
    rec = dict(
        pairs=pairs, kmers=stats.get("kmers_distinct"),
        scaffold_mode=stats.get("scaffold_mode") or "legacy",
        joins={k: stats.get(k, 0) for k in ("star_gap_joins", "barcode_joins")},
        assembly_checksum=stats.get("assembly_checksum"),
        summary=assembly_keys(json.loads((rundir / "summary.json").read_text())),
        alerts=json.loads((rundir / "alerts.json").read_text()),
        all_stats=assembly_keys(stats),
        histograms={p.stem[len("histogram_"):]: json.loads(p.read_text())
                    for p in sorted((rundir / "stats").glob("histogram_*.json"))},
        fasta={fl: fasta_digest(rundir / f"assembly.{fl}.fasta.gz") for fl in flavors})
    if eval_dict is not None:
        rec["eval"] = eval_dict
    return rec


def flatten(rec: dict) -> dict:
    """A record as one level of keys: the scalars, joins.*, summary.*,
    all_stats.* (those summary.json does not hold), alerts, eval.*,
    histogram_*, fasta.<flavor>.  A key the record lacks is left out."""
    out = {k: rec[k] for k in ("pairs", "kmers", "scaffold_mode", "assembly_checksum")
           if rec.get(k) is not None}
    summary = rec.get("summary", {})
    parts = (("joins", rec.get("joins", {})), ("summary", summary),
             ("all_stats", {k: v for k, v in rec.get("all_stats", {}).items()
                            if k not in summary}),
             ("eval", rec.get("eval", {})), ("fasta", rec.get("fasta", {})))
    for name, d in parts:
        out.update({f"{name}.{k}": v for k, v in d.items()})
    if "alerts" in rec:
        out["alerts"] = rec["alerts"]
    out.update({f"histogram_{k}": v for k, v in rec.get("histograms", {}).items()})
    return out


def short(v):
    """v, or "sha256:<16 hex>" of its JSON where that is long."""
    s = json.dumps(v, sort_keys=True)
    return v if len(s) <= SHORT_JSON else "sha256:" + hashlib.sha256(s.encode()).hexdigest()[:16]


def compare(want: dict, got: dict) -> dict:
    """Each key of the flat record `want`: {"reference", "ours", "result"},
    the result "equal", "differs" or "not run" (a key `got` lacks)."""
    out = {}
    for k, w in want.items():
        g = got.get(k)
        res = "not run" if k not in got else ("equal" if g == w else "differs")
        out[k] = dict(reference=short(w), ours=short(g), result=res)
    return out


CHECKPOINTS = ("kmers.npz", "graph.npz", "paths.npz", "graph.patched.npz", "cpaths.npz",
               "dpaths.npz", "supergraph.npz")


def digests(rundir) -> dict:
    """{checkpoint: {array: "dtype shape sha256"}} of the outdir's
    checkpoints in stage order, the scaffold phases' snapshots last (in
    the order of their directories' times)."""
    import numpy as np

    rundir = Path(rundir)
    files = [rundir / f for f in CHECKPOINTS if (rundir / f).exists()]
    files += sorted(rundir.glob("*/a.sup.npz"), key=lambda p: p.stat().st_mtime)
    out = {}
    for path in files:
        with np.load(path, allow_pickle=False) as z:
            out[str(path.relative_to(rundir))] = {
                k: f"{z[k].dtype} {list(z[k].shape)} "
                   f"{hashlib.sha256(np.ascontiguousarray(z[k]).tobytes()).hexdigest()[:16]}"
                for k in sorted(z.files)}
    return out


def load_record(name: str) -> dict:
    return json.loads((RECORDS / name).read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m supernova_tpu_torch.stats.rung_record")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record", help="write the record of a run's outdir")
    r.add_argument("--run", required=True, help="the outdir of `run`")
    r.add_argument("--eval", required=True, help="evaluate's printed output")
    r.add_argument("--sim-json", required=True, help="simulate's printed JSON (n_pairs)")
    r.add_argument("--commit", required=True)
    r.add_argument("--command", action="append", default=[])
    r.add_argument("--note", action="append", default=[])
    r.add_argument("--out", required=True)
    d = sub.add_parser("digests", help="print the digests of an outdir's checkpoints")
    d.add_argument("run")
    args = ap.parse_args(argv)
    if args.cmd == "digests":
        print(json.dumps(digests(args.run), indent=1))
        return 0
    sim = json.loads(Path(args.sim_json).read_text().strip().splitlines()[-1])
    rec = dict(commit=args.commit, commands=args.command, notes=args.note,
               **assembly_record(args.run, load_eval(args.eval), pairs=sim["n_pairs"]))
    Path(args.out).write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
