"""Block planning of supernova_tpu_torch: the count's and the pather's block
budgets (count_block_positions, path_block_positions) driven by injected
free-byte counts, since no card can be had here; the blocked count and
pather at two block sizes against each other and against the JAX
reference's count and paths on the 8 kb slice; a resumed count taking the
block size its spill records; halving_retry from a given start; and the
rung script (stats/rung.py) in a fresh process.  On the CPU, exact
equality."""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from supernova_tpu.align import pather as rpather
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.dbg import graph as rgraph
from supernova_tpu.kmer import count as rcount
from supernova_tpu_torch import convert
from supernova_tpu_torch.align import pather
from supernova_tpu_torch.dbg import graph as dgraph
from supernova_tpu_torch.kmer import count as kcount
from supernova_tpu_torch.kmer import spill
from supernova_tpu_torch.pipeline import datasets
from supernova_tpu_torch.stats import rung

from tests.test_torch_count import assert_tables_equal

CUDA = torch.device("cuda")  # a device object only: nothing here touches a card
GIB = 1 << 30
SIZES = (300_000, 700_000)  # two block sizes of the 8 kb slice's 1.28M bases
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread a test worker (see
    tests/test_torch_partitioned.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8 kb slice, the reference's count of it, and the reference's
    graph as both packages' BaseGraph."""
    rs = datasets.simulate(datasets.SMALL, datasets.SMALL_SEED)
    ref = rcount.count_readset(rs)
    table = rbuild.trim_table(ref, pad_multiple=256)
    rbg = rgraph.from_device(rbuild.build_graph(table), table)
    path = tmp_path_factory.mktemp("blocks") / "graph.npz"
    rbg.save(path)
    return rs, ref, rbg, dgraph.BaseGraph.load(path)


# ---------------------------------------------------------------- budgets

@pytest.mark.parametrize("free_gib", [8, 40, 79.3])
def test_count_budget_from_free_bytes(free_gib):
    """Free bytes over COUNT_BYTES_PER_POSITION, rounded down to 2^20."""
    free = int(free_gib * GIB)
    got = kcount.count_block_positions(CUDA, free_bytes=free)
    want = free // kcount.COUNT_BYTES_PER_POSITION // (1 << 20) * (1 << 20)
    assert got == want and got % kcount.BLOCK_QUANTUM == 0
    assert got <= free // kcount.COUNT_BYTES_PER_POSITION < got + (1 << 20)


def test_count_budget_clamps_and_caps():
    """Below MIN_BLOCK_POSITIONS' bytes the budget is MIN_BLOCK_POSITIONS;
    above MAX_BLOCK_POSITIONS' it is capped there, below 2^31 with room for
    a read bucket's padding (prepare_reads' int32 offsets, K4's 32-bit row
    indices)."""
    assert kcount.count_block_positions(CUDA, free_bytes=0) == kcount.MIN_BLOCK_POSITIONS
    assert kcount.count_block_positions(CUDA, free_bytes=1 << 30) == kcount.MIN_BLOCK_POSITIONS
    top = kcount.count_block_positions(CUDA, free_bytes=1 << 50)
    assert top == kcount.MAX_BLOCK_POSITIONS and top % kcount.BLOCK_QUANTUM == 0
    assert top + 150 * 128 < 1 << 31 and top + kcount.BASE_BUCKET < 1 << 31


def test_budgets_on_the_cpu_are_the_reference_block(monkeypatch):
    """The CPU plans the reference's 96M-position blocks, whatever the
    injected bytes, and follows BLOCK_POSITIONS when a test sets it."""
    bg = SimpleNamespace(kmer_words=np.zeros((10, 3), np.uint32))
    for dev in ("cpu", torch.device("cpu")):
        assert kcount.count_block_positions(dev) == 96_000_000
        assert kcount.count_block_positions(dev, free_bytes=1 << 40) == 96_000_000
        assert pather.path_block_positions(dev, bg) == 96_000_000
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 123_456)
    assert kcount.count_block_positions("cpu") == 123_456
    assert pather.path_block_positions("cpu", bg) == 123_456


@pytest.mark.parametrize("m", [10_000, 10_485_760, 130_000_000])
def test_path_budget_charges_the_dictionary(m):
    """The pather's budget: the bytes free with no dictionary on the card,
    less PATH_BYTES_PER_DICT_ROW a dictionary row, over
    PATH_BYTES_PER_POSITION; capped so that a block's queries and the
    dictionary's rows sort below 2^31."""
    bg = SimpleNamespace(kmer_words=np.zeros((m, 3), np.uint32))
    free = 70 * GIB
    got = pather.path_block_positions(CUDA, bg, free_bytes=free)
    room = (free - m * pather.PATH_BYTES_PER_DICT_ROW) // pather.PATH_BYTES_PER_POSITION
    assert got == room // (1 << 20) * (1 << 20)
    assert got < kcount.count_block_positions(CUDA, free_bytes=free)
    assert pather.path_block_positions(CUDA, bg, free_bytes=m * pather.PATH_BYTES_PER_DICT_ROW) \
        == kcount.MIN_BLOCK_POSITIONS
    top = pather.path_block_positions(CUDA, bg, free_bytes=1 << 50)
    assert top + m < 1 << 31 and top % kcount.BLOCK_QUANTUM == 0


def test_path_budget_places_nothing(monkeypatch, world):
    """Planning a paths block puts no dictionary on the card; a dictionary
    already there counts as free room, since its rows are charged."""
    bg = world[3]
    m = int(bg.kmer_words.shape[0])
    free = 30 * GIB
    monkeypatch.setattr(kcount, "free_device_bytes", lambda device: free)
    bare = pather.path_block_positions(CUDA, bg)
    assert CUDA not in bg.__dict__.get("_device_arrays", {})
    assert bare == pather.path_block_positions(CUDA, bg, free_bytes=free)
    placed = bg.device_arrays("cpu")
    assert pather._placed_bytes(bg, torch.device("cpu")) == 8 * (
        3 * m + sum(len(a) for a in (bg.node_edge, bg.node_pos, bg.from_v, bg.to_v))
        + bg.n_edges)
    # the same tensors as if they lay on the card: free is that much less
    bg._device_arrays[CUDA] = placed
    try:
        monkeypatch.setattr(kcount, "free_device_bytes",
                            lambda device: free - pather._placed_bytes(bg, CUDA))
        assert pather.path_block_positions(CUDA, bg) == bare
    finally:
        del bg._device_arrays[CUDA]


# ------------------------------------------------- two block sizes, one output

def test_blocked_count_at_two_sizes_matches_reference(world):
    rs, ref, _, _ = world
    tables = []
    for size in SIZES:
        info = {}
        tables.append(kcount.count_readset_blocked(rs, "cpu", max_positions=size, info=info))
        assert info["block_positions"] == size and info["blocks"] >= 2
        assert_tables_equal(ref, tables[-1])
    a, b = (convert.table_to_numpy(t) for t in tables)
    for x, y in zip((*a.words, *a[1:5]), (*b.words, *b[1:5])):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # an explicit block size wins over the budget in count_readset too
    info = {}
    assert_tables_equal(ref, kcount.count_readset(rs, "cpu", info=info, max_positions=SIZES[0]))
    assert info["block_positions"] == SIZES[0] and info["blocks"] >= 3


@pytest.mark.parametrize("size", [None, SIZES[0]])
def test_count_records_its_first_block(world, size):
    """The count's info holds its first block's positions (padding
    included) and sort rows, one block or blocked: what a kernel check at
    the count's own shapes must match."""
    rs = world[0]
    info = {}
    kcount.count_readset(rs, "cpu", info=info, max_positions=size)
    blocks = kcount.split_readset_blocks(rs, info["block_positions"])
    assert len(blocks) == info["blocks"]
    p = (kcount.prepare_reads(rs, "cpu") if len(blocks) == 1 else kcount.prepare_reads(
        blocks[0], "cpu", pad_to_positions=max(int(b.offsets[-1]) for b in blocks),
        pad_to_reads=max(b.n_reads for b in blocks)))
    _, pk = kcount.occurrence_rows(p["codes_ext"], p["pos_read"], p["glen_pos"], p["bc_pos"],
                                   p["uniform_rl"])
    assert info["first_block_positions"] == p["pos_read"].shape[0]
    assert info["first_block_sort_rows"] == pk.shape[0] < p["pos_read"].shape[0]


def test_blocked_pather_at_two_sizes_matches_reference(world):
    rs, _, rbg, pbg = world
    ref = rpather.path_readset(rbg, rs)
    n = rs.n_reads
    got = []
    for size in SIZES:
        info = {}
        got.append(convert.readpaths_to_numpy(
            pather.path_readset(pbg, rs, "cpu", info=info, max_positions=size)))
        assert info["blocks"] >= 2 and info["block_positions"] == size
        assert info["oom_retries"] == 0
    for f, r, x, y in zip(got[0]._fields, ref, *got):
        assert x.shape[0] == y.shape[0] == n, f
        assert np.array_equal(np.asarray(r)[:n], x) and np.array_equal(x, y), f
    assert (got[0].path_len > 0).mean() > 0.9


# ------------------------------------------------------------------ resume

def test_resumed_count_takes_the_spilled_block_size(world, tmp_path, monkeypatch):
    """A count whose spill directory holds this readset's blocks takes the
    block size its meta records -- not the budget it would derive now --
    recounts no block and gives the same table; a spill of other reads
    is not taken."""
    rs, ref, _, _ = world
    d = tmp_path / "spill"
    info = {}
    kcount.count_readset_blocked(rs, "cpu", max_positions=SIZES[0], spill_dir=d, info=info)
    blocks = info["blocks"]
    assert spill.read_meta(d)["block_positions"] == SIZES[0]
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", SIZES[1])  # what the device would derive now
    assert kcount.planned_block_positions(rs, "cpu", kcount.MIN_FREQ, kcount.MIN_BC, d) == SIZES[0]
    assert kcount.planned_block_positions(rs, "cpu", kcount.MIN_FREQ, 1, d) == SIZES[1]
    assert kcount.planned_block_positions(rs, "cpu", kcount.MIN_FREQ, kcount.MIN_BC,
                                          tmp_path / "none") == SIZES[1]
    recount = []
    real = kcount.count_block_raw
    monkeypatch.setattr(kcount, "count_block_raw",
                        lambda *a, **k: recount.append(1) or real(*a, **k))
    for fn in (lambda i: kcount.count_readset_blocked(rs, "cpu", spill_dir=d, info=i),
               lambda i: kcount.count_readset(rs, "cpu", spill_dir=d, info=i)):
        info = {}
        assert_tables_equal(ref, fn(info))
        assert info["block_positions"] == SIZES[0] and info["blocks"] == blocks
        assert info["resumed_blocks"] == blocks and info["spilled_blocks"] == 0
    assert not recount


# ------------------------------------------------------------ halving_retry

def _oom_until(limit, sizes):
    def attempt(max_pos):
        sizes.append(max_pos)
        if max_pos > limit:
            raise torch.cuda.OutOfMemoryError(f"no room for {max_pos}")
        return max_pos
    return attempt


def test_halving_retry_halves_from_its_start(monkeypatch):
    monkeypatch.setattr(kcount, "MIN_BLOCK_POSITIONS", 25_000)
    sizes, info = [], {}
    assert kcount.halving_retry("t", torch.device("cpu"), info,
                                _oom_until(100_000, sizes), 400_000) == 100_000
    assert sizes == [400_000, 200_000, 100_000] and info["oom_retries"] == 2
    sizes, info = [], {}
    with pytest.raises(torch.cuda.OutOfMemoryError):
        kcount.halving_retry("t", torch.device("cpu"), info, _oom_until(1_000, sizes), 400_000)
    assert sizes == [400_000, 200_000, 100_000, 50_000, 25_000] and "oom_retries" not in info
    # another error is not an OOM: it raises at once
    with pytest.raises(ValueError):
        kcount.halving_retry("t", torch.device("cpu"), None,
                             lambda p: (_ for _ in ()).throw(ValueError(p)), 400_000)


# -------------------------------------------------------------- the rung

RUNG = ["--genome-size", "20000", "--repeats", "2", "--barcodes", "40",
        "--whitelist-size", "128", "--seed", "3"]


@pytest.fixture(scope="module")
def rung_run(tmp_path_factory):
    """stats/rung.py through paths on the CPU in a fresh process (it forks
    its simulation and lane writers, which a process holding JAX's threads
    must not) -> (its directory, its stdout's JSON lines)."""
    root = tmp_path_factory.mktemp("rung")
    argv = ["--out", str(root), *RUNG, "--through", "paths", "--device", "cpu", "--check-96m"]
    code = ("import json, sys, torch\n"
            "torch.set_num_threads(1)  # one intra-op thread, as this file's tests\n"
            "from supernova_tpu_torch.stats import rung\n"
            f"rc = rung.main({argv!r})\n"
            "print(json.dumps({'rc': rc, 'foreign': sorted(m for m in sys.modules\n"
            "      if m.split('.')[0] in ('jax', 'jaxlib', 'supernova_tpu'))}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return root, [json.loads(x) for x in out.stdout.splitlines()]


def test_rung_through_paths_in_a_fresh_process(rung_run):
    """One JSON line a step, the stages up to --through and no further, the
    last line the comparison; no jax or supernova_tpu module imported."""
    root, lines = rung_run
    assert lines[-1] == {"rc": 0, "foreign": []}
    steps = [x["step"] for x in lines[:-1]]
    assert steps == ["simulate", "fastq ingest", "ingest", "count", "graph", "paths",
                     "raw rows at 96M", "compare"]
    by = {x["step"]: x for x in lines[:-1]}
    assert by["simulate"]["pairs"] * 2 == by["fastq ingest"]["reads"] == by["paths"]["reads"]
    assert by["count"]["kmers"] > 10_000 and by["count"]["blocks"] == 1
    assert by["count"]["block_positions"] == 96_000_000
    assert by["raw rows at 96M"]["raw_rows"] >= by["count"]["kmers"]
    assert by["raw rows at 96M"]["block_raw_rows"] == [by["raw rows at 96M"]["raw_rows"]]
    assert by["graph"]["edges"] > 0 and by["paths"]["placed_perc"] > 95
    for s in ("count", "graph", "paths"):
        x = by[s]
        assert x["wall_s"] >= 0 and x["device_peak_gib"] is None
        assert set(x["launches"]) == {"kmer_extract", "compact", "run_reduce", "sort",
                                      "scan_max"}
        assert 0 < x["host_RssAnon_peak_gb"] <= x["host_VmRSS_peak_gb"]
        assert x["disk_free_gb_after"] > 0
    for name in ("kmers.npz", "graph.npz", "paths.npz"):
        assert (root / "run" / name).exists()
    assert not (root / "run" / "graph.patched.npz").exists()
    assert len(list((root / "sim").glob("RUNG_S1_L00?_R?_001.fastq.gz"))) == 16


def test_rung_compares_with_the_reference_and_resumes(rung_run, monkeypatch, capsys):
    """A rung of REFERENCE: each recorded number equal, differs or not run;
    run again on the same directory, it resumes every step."""
    root, first = rung_run
    kmers = first[3]["kmers"]
    monkeypatch.setitem(rung.REFERENCE, (20000, 2, 40, 128, 3),
                        dict(source="test", kmers=kmers, pairs=1, patch_kmers=5))
    assert rung.main(["--out", str(root), *RUNG, "--through", "count", "--device", "cpu"]) == 0
    again = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in again] == ["simulate", "reads.npz", "ingest", "count", "compare"]
    assert again[0] == {"step": "simulate", "skipped": True, "pairs": first[0]["pairs"]}
    assert again[1]["step"] == "reads.npz" and again[3]["resumed_from_kmers_npz"]
    assert again[-1]["compare"] == {
        "kmers": {"reference": kmers, "ours": kmers, "result": "equal"},
        "pairs": {"reference": 1, "ours": first[0]["pairs"], "result": "differs"},
        "patch_kmers": {"reference": 5, "ours": None, "result": "not run"}}


def test_rung_recounts_at_96m_where_the_kmers_differ(rung_run, monkeypatch, capsys):
    """--check-96m on a rung whose recorded kmers differ from this run's:
    the count again at the reference's 96M-position blocks, right after
    the count stage, its table equal to the stage's and its raw rows those
    of the first run's 96M check."""
    root, first = rung_run
    by = {x.get("step"): x for x in first}
    raw = by["raw rows at 96M"]["raw_rows"]
    monkeypatch.setitem(rung.REFERENCE, (20000, 2, 40, 128, 3),
                        dict(source="test", kmers=by["count"]["kmers"] + 1, raw_rows_96m=raw,
                             raw_rows_96m_blocks=[raw, 7]))
    assert rung.main(["--out", str(root), *RUNG, "--through", "count", "--device", "cpu",
                      "--check-96m"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == ["simulate", "reads.npz", "ingest", "count",
                                          "count at 96M", "compare"]
    assert lines[4]["table_equal"] and lines[4]["raw_rows"] == raw
    assert lines[4]["block_raw_rows"] == [raw]
    assert lines[4]["kmers"] == by["count"]["kmers"]
    assert not (root / "check_spill").exists()
    assert lines[-1]["compare"]["kmers"]["result"] == "differs"
    assert lines[-1]["compare"]["raw_rows_96m"] == {"reference": raw, "ours": raw,
                                                     "result": "equal"}
    # a block at a time; a block the run does not have differs
    assert lines[-1]["compare"]["raw_rows_96m_blocks"] == {
        "reference": [raw, 7], "ours": [raw], "result": ["equal", "differs"]}


def test_rung_through_supergraph_runs_the_command_and_holds_a_record(rung_run, monkeypatch,
                                                                      capsys, tmp_path):
    """Past patch the rung runs `run --resume` in this process, which runs
    every stage from reads.npz (a line each) and stops after the
    --through stage's line; a rung with a record file compares each of the
    record's keys: the count's equal, the outputs' not run (the command
    stopped before them)."""
    from supernova_tpu_torch.stats import rung_record

    root, first = rung_run
    assert rung.STAGES == ("count", "graph", "paths", "patch", "supergraph", "scaffold",
                           "fasta", "evaluate")
    kmers = first[3]["kmers"]
    (tmp_path / "t.json").write_text(json.dumps(dict(
        pairs=first[0]["pairs"], kmers=kmers + 1, summary={"nreads": 1}, alerts=[])))
    monkeypatch.setattr(rung_record, "RECORDS", tmp_path)
    monkeypatch.setitem(rung.REFERENCE, (20000, 2, 40, 128, 3),
                        dict(source="test", record="t.json"))
    assert rung.main(["--out", str(root), *RUNG, "--through", "supergraph",
                      "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == ["simulate", "reads.npz", "ingest", "count", "graph",
                                          "paths", "patch", "supergraph", "compare"]
    by = {x["step"]: x for x in lines}
    assert by["count"]["resumed_from_kmers_npz"] and by["count"]["kmers"] == kmers
    assert by["patch"]["rebuild_kmers"] > 0 and by["supergraph"]["glue_route"] == "host"
    assert sum(by["supergraph"]["launches"].values()) == 0
    assert (root / "run" / "supergraph.npz").exists()
    assert not (root / "run" / "splay").exists()  # stopped before the scaffold stage
    cmp = lines[-1]
    assert {k: v["result"] for k, v in cmp["compare"].items()} == {
        "pairs": "equal", "kmers": "differs", "summary.nreads": "not run", "alerts": "not run"}
    assert cmp["counts"] == {"equal": 1, "differs": 1, "not run": 2}
    assert json.loads((root / "compare.json").read_text()) == cmp


def test_checksum_native_equals_python_loop(world, monkeypatch):
    """BaseGraph.checksum through native/fnv.cpp equals its Python loop
    (taken where g++ is missing) and the reference's value."""
    from supernova_tpu_torch import native as fnv

    _, _, rbg, pbg = world
    assert fnv.fnv1a_64(b"", 7) == 7
    assert fnv.fnv1a_64(b"A", 0xCBF29CE484222325) == 0xAF63FC4C860222EC
    native = pbg.checksum()
    monkeypatch.setattr(fnv, "fnv1a_64", lambda data, h: None)
    assert pbg.checksum() == native == rbg.checksum()


def test_rss_parts_from_smaps_where_status_has_no_split(monkeypatch, tmp_path):
    """A kernel whose /proc/self/status has VmRSS but no RssAnon/RssFile
    lines: the anonymous and file-backed parts come from the smaps sums."""
    import builtins

    status = tmp_path / "status"
    status.write_text("Name:\tpython\nVmRSS:\t  2048 kB\n")
    smaps = tmp_path / "smaps"
    smaps.write_text("00400000-00452000 r-xp 00000000 08:02 173521 /usr/bin/python\n"
                     "Rss:                 300 kB\nAnonymous:            20 kB\n"
                     "7f00-7f80 rw-p 00000000 00:00 0\nRss:                 700 kB\n"
                     "Anonymous:           700 kB\n")
    real = builtins.open
    paths = {"/proc/self/status": status, "/proc/self/smaps": smaps}
    monkeypatch.setattr(builtins, "open", lambda p, *a, **k: real(paths.get(p, p), *a, **k))
    assert rung.rss_parts() == {"VmRSS": 2048 * 1024, "RssAnon": 720 * 1024,
                                "RssFile": 280 * 1024}
