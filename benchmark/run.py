"""One run of one cell of BENCHMARK.json on one card.

    python3 -m benchmark --workload CELL --seed N --seconds S --trace 0|1

Set-up: the cell's readset from the seed (benchmark/gen), the entry's own
set-up (benchmark/entries/<entry>.py), one warm call.  The window: whole
calls back to back; the call in flight when S seconds have passed is
finished.  Each call ends in torch.cuda.synchronize() and leaves the
fingerprint of its output.  After the window the program's state is
freed and the plain reference (benchmark/reference) works out the answer
from the same reads; `correct` holds when every number compared is within
its limit.  With --trace 1 a torch.profiler covers the window and the
cell's per-layer readers (benchmark/metrics/<metric>.py) read it.
Earlier lines of standard output carry each call's counters; the last is
the result.  The numbers compared close standard error.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "supernova_tpu")


def log(**kv) -> None:
    print(json.dumps(kv), flush=True)


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(spec: dict, name: str):
    """(cell, config dict, traffic dict, end-to-end metrics, per-layer
    metrics) of the cell `name`, all found by name."""
    cell = next(w for w in spec["workloads"] if w["name"] == name)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", []) or ("workloads" not in m and m["moves"] in reported)]
    return cell, config, traffic, e2e, layer


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line(device) -> dict:
    """The card's name and power limit, for the record."""
    if device.type != "cuda":
        return {"card": "cpu"}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"nvidia-smi: {e}"
    return {"card": torch.cuda.get_device_name(device), "nvidia_smi": limit}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             spec: dict | None = None, config: dict | None = None,
             t0: float | None = None) -> dict:
    """One run of cell `name` on `device` -> the result line (a dict).
    config replaces the cell's configuration (the tests' small sizes); t0
    is when set-up began (now by default)."""
    from supernova_tpu_torch.ops import kernels

    from . import judge, trace as tracing
    from .entries import load
    from .gen.linked_reads import generate

    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    spec = spec or load_spec()
    _, cfg, traffic, e2e, layer = cell_parts(spec, name)
    cfg = config or cfg
    log(cell=name, seed=seed, **card_line(device))
    t_start = time.perf_counter()

    reads = generate(cfg, seed, device, r1_trim=int(traffic.get("r1_trim", 0)))
    free(device)
    t_gen = time.perf_counter()
    entry = load(traffic["entry"])(reads, device)
    log(prepare=entry.prepare(), reads=reads.n_reads, bases=reads.n_bases)
    t_prep = time.perf_counter()
    warm: dict = {}
    out = entry.call(warm)
    fps = [judge.fingerprint(entry.columns(out))]
    del out
    free(device)
    t_warm = time.perf_counter()
    log(warm_call=warm, warm_s=t_warm - t_prep)
    setup = {"start_s": t_start - t0, "gen_s": t_gen - t_start, "prepare_s": t_prep - t_gen,
             "warm_s": t_warm - t_prep}

    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda)
        prof.start()
    span = (lambda n: torch.profiler.record_function(n)) if trace else (lambda n: nullcontext())
    failed, calls = [], []
    setup_s = time.perf_counter() - t0
    with span("window"):
        w0 = time.perf_counter()
        while True:
            info: dict = {}
            before = kernels.launch_counts()
            c0 = time.perf_counter()
            with span(entry.span):
                out = entry.call(info)
                fp = judge.fingerprint(entry.columns(out))
                sync(device)
            c1 = time.perf_counter()
            fps.append(fp)
            calls.append(c1 - c0)
            why = entry.fault(info)
            if why:
                failed.append(why)
            log(call=len(calls), seconds=c1 - c0, info=info,
                launches=kernels.launches_since(before), failed=why)
            if c1 - w0 >= seconds:
                break
            del out
        w1 = time.perf_counter()
    window_s = w1 - w0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr = None
    if prof is not None:
        prof.stop()
        t_red = time.perf_counter()
        tr = tracing.reduce(prof, peak)
        del prof
        log(trace_events=len(tr.device) + len(tr.host_ops), reduce_s=time.perf_counter() - t_red)
    last = [c.cpu().numpy() for c in entry.columns(out)]
    del out
    entry.release()
    free(device)

    # the reference, once the program's state is gone
    r0 = time.perf_counter()
    ref = entry.reference()
    fp_ref = judge.fingerprint(ref)
    numbers = {"calls_off": sum(fp != fp_ref for fp in fps)}
    numbers.update(entry.compare(last, [c.cpu().numpy() for c in ref]))
    del ref
    free(device)
    log(reference_s=time.perf_counter() - r0, calls=len(calls), call_s=calls, setup=setup,
        setup_s=setup_s, window_s=window_s)

    if trace:
        metrics = {}
        for m in layer:
            v = reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = entry.end_to_end(len(calls), window_s)
        values["setup_s"] = (setup_s, "s")
        metrics = {m["name"]: {"value": values[m["name"]][0], "unit": values[m["name"]][1]}
                   for m in e2e}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": max(peak, setup_peak)}
    result = {"correct": all(v <= 0 for v in numbers.values()), "attempted": len(calls),
              "failed": len(failed), "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tracing.busy_s(tr.device, *tr.window)
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tracing.device_ops(tr),
                               "idle_gaps": tracing.idle_gaps(tr)}
    result["checks"] = {k: {"value": v, "limit": 0} for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"benchmark: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    from . import STARTED

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), spec, t0=STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}", file=sys.stderr)
        return 3
    checks = ", ".join(f"{k} {c['value']} (limit {c['limit']})"
                       for k, c in result["checks"].items())
    print(json.dumps(result), flush=True)
    print(f"correct={result['correct']}: {checks}", file=sys.stderr, flush=True)
    return 0
