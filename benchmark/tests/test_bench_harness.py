"""CPU tests of the benchmark harness at small sizes.

    python -m pytest benchmark/tests -q

The generator, the plain reference against the program's CPU path, the
shape of a run's last line, the no-JAX check, the per-layer readers on a
made-up trace, and BENCHMARK.json against the contract's limits.  The
`cuda` test runs every cell once at a small size on a card; it skips
without one.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import judge, run, trace
from benchmark.entries import load
from benchmark.gen.linked_reads import generate

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = [0, 7, 2**31 + 11, 3_000_000_017]


def small(config: str, pairs: int = 3000) -> dict:
    """The configuration cut to a 30 kb genome (the tests' size)."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    cfg.update(genome_size=30_000, repeats=2, barcodes=40, whitelist_size=128,
               molecule_len=6_000, pairs=pairs)
    return cfg


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_is_fixed_by_its_seed(seed):
    cfg = small("val10mb", pairs=1_575_580 // 500)
    a, b = generate(cfg, seed, "cpu"), generate(cfg, seed, "cpu")
    for f in ("codes", "offsets", "quals", "bc", "bci"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.n_reads == 2 * cfg["pairs"]
    assert a.n_bases == 2 * cfg["pairs"] * cfg["read_len"]
    assert (np.diff(a.bc) >= 0).all() and (a.bc[0::2] == a.bc[1::2]).all()
    assert a.bci[0] == 0 and a.bci[-1] == a.n_reads and len(a.bci) == cfg["whitelist_size"] + 2
    assert np.array_equal(a.bci, np.searchsorted(a.bc, np.arange(len(a.bci))))
    other = generate(cfg, seed + 1, "cpu")
    assert not np.array_equal(a.codes, other.codes)


def test_generator_error_rates_and_trim():
    cfg = small("val10mb_err15", pairs=4000)
    r = generate(cfg, 5, "cpu", r1_trim=23)
    lens = np.diff(r.offsets)
    assert (lens[0::2] == 127).all() and (lens[1::2] == 150).all()
    low = (r.quals == cfg["error_qual"]).mean()
    assert abs(low - 0.015) < 0.002
    assert set(np.unique(r.quals)) <= {cfg["base_qual"], cfg["error_qual"]}
    assert 0 < (r.bc == 0).mean() < 0.03  # barcodes with two or more wrong bases


@pytest.mark.parametrize("traffic", ["count", "paths"])
@pytest.mark.parametrize("config", ["val10mb", "val10mb_err15"])
@pytest.mark.parametrize("r1_trim", [0, 23])
def test_reference_equals_the_program_on_the_cpu(traffic, config, r1_trim):
    reads = generate(small(config), 11, "cpu", r1_trim=r1_trim)
    entry = load(traffic)(reads, "cpu")
    entry.prepare()
    info: dict = {}
    out = entry.columns(entry.call(info))
    assert entry.fault(info) is None
    ref = entry.reference()
    assert judge.fingerprint(out) == judge.fingerprint(ref)
    numbers = entry.compare([c.numpy() for c in out], [c.numpy() for c in ref])
    assert numbers and all(v == 0 for v in numbers.values()), numbers


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_small_run_prints_the_contract_line(name, traced):
    cell, cfg, _, e2e, layer = run.cell_parts(SPEC, name)
    res = run.run_cell(name, 2**31 + 3, 0.2, traced, "cpu", SPEC, small(cell["config"]))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["limit"] == 0 and c["value"] == 0 for c in res["checks"].values())
    json.dumps(res)
    if traced:
        # no device events on the CPU: every reader finds nothing
        assert res["metrics"] == {}
        assert set(res["device"]) >= {"busy_s", "window_s"} and "breakdown" in res
    else:
        assert set(res["metrics"]) == {m["name"] for m in e2e}
        for m in e2e:
            assert res["metrics"][m["name"]]["unit"] == m["unit"]
            assert res["metrics"][m["name"]]["value"] > 0


def test_without_a_card_the_run_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_jax_in_a_run():
    code = ("import json; from benchmark import run; "
            f"run.run_cell('paths.val10mb', 1, 0.1, False, 'cpu', None, {small('val10mb')!r}); "
            "print(json.dumps(run.forbidden_modules()))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env={"PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "supernova_tpu")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "supernova_tpu_torch_fake", object())
    assert "supernova_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy_fake", object())
    assert run.forbidden_modules() == ["jax"]


def _trace():
    # two calls of 1 s; the device busy 0.25 s in each, 0.1 s of it in K4
    dev = [(0.1, 0.2, "onesweep_kernel"), (0.2, 0.35, "elementwise_kernel"),
           (1.1, 1.2, "onesweep_kernel"), (1.3, 1.45, "elementwise_kernel")]
    spans = {"window": [(0.0, 2.0)], "call.count": [(0.0, 1.0), (1.0, 2.0)]}
    host = [(0.5, 0.9, "aten::copy_"), (0.4, 0.95, "outer")]
    return trace.Trace((0.0, 2.0), dev, spans, host, 3 * 2**30)


def test_readers_on_a_made_up_trace():
    tr = _trace()
    val = lambda m: run.reader(m)(tr)
    assert val("host_s.count") == pytest.approx(0.75)
    assert val("kernel_s.count") == pytest.approx(0.1)
    assert val("torch_ops_s.count") == pytest.approx(0.15)
    assert val("idle_share.count") == pytest.approx(0.75)
    assert val("peak_gib.count") == pytest.approx(3.0)
    for m in ("host_s.paths", "kernel_s.paths", "torch_ops_s.paths", "idle_share.paths",
              "peak_gib.paths"):
        assert val(m) is None  # nothing of a paths call in a count window
    assert trace.device_ops(tr) == [["elementwise_kernel", pytest.approx(0.3)],
                                    ["onesweep_kernel", pytest.approx(0.2)]]
    gaps = trace.idle_gaps(tr)
    assert gaps[:2] == [["aten::copy_", pytest.approx(0.75)], ["call.count", pytest.approx(0.55)]]
    tr.host_ops.append((1.7, 1.8, "aten::to"))  # the gap's middle is 1.725
    assert trace.idle_gaps(tr)[1] == ["aten::to", pytest.approx(0.55)]
    tr.host_ops[-1] = (1.8, 1.9, "aten::to")
    assert trace.idle_gaps(tr)[1] == ["call.count before aten::to", pytest.approx(0.55)]
    empty = trace.Trace((0.0, 1.0), [], {"window": [(0.0, 1.0)], "call.count": [(0.0, 1.0)]})
    assert all(run.reader(m["name"])(empty) is None for m in SPEC["per_layer"])


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    s = SPEC
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and 1 <= s["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in s[k]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in s["workloads"])
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in s["end_to_end"])
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and len(m["layer"]) <= 200
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        moved = next(x for x in s["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for w in CELLS:
        _, _, _, e2e_w, layer_w = run.cell_parts(s, w)
        assert "setup_s" in {m["name"] for m in e2e_w} and len(e2e_w) >= 2 and layer_w


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_once_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = next(w for w in SPEC["workloads"] if w["name"] == name)
    res = run.run_cell(name, 2**31 + 1, 1.0, True, "cuda", SPEC, small(cell["config"], 20_000))
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["busy_s"] > 0 and res["metrics"]
