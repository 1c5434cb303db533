"""The 10x Chromium read layout (R1 127 + R2 150 after ingest's barcode
trim) on the CPU: the row counters of the count and the pather
(stats/trace.py `count_rows`: sort_rows, dead_sort_rows, join_rows,
dead_join_rows) against a numpy count from the reads, for uniform and
trimmed readsets; nothing counted without a profiler; and the benchmark's
two cells of the layout, count.val10mb_r1trim and paths.val10mb_r1trim,
at a small size through `run_cell`."""
import json
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import run as bench_run
from benchmark.gen import linked_reads
from supernova_tpu_torch.align import pather
from supernova_tpu_torch.core import kmer_codec as kc
from supernova_tpu_torch.core.kmer_codec import K
from supernova_tpu_torch.dbg import build, graph
from supernova_tpu_torch.ingest.reads import ReadSet
from supernova_tpu_torch.kmer import count as kcount
from supernova_tpu_torch.pipeline import datasets
from supernova_tpu_torch.stats import trace as st

ROOT = Path(__file__).resolve().parents[1]
ROW_COUNTERS = ("sort_rows", "dead_sort_rows", "join_rows", "dead_join_rows")


def with_bad_bases(rs: ReadSet, seed: int = 3) -> ReadSet:
    """rs with qualities below MIN_QUAL at 0.5% of its bases, and at every
    sixth base of one read in 40 (whose good length then falls below
    min_read_len): good lengths that differ from read lengths."""
    rng = np.random.default_rng(seed)
    quals = rs.quals.copy()
    quals[rng.random(len(quals)) < 0.005] = 2
    for r in range(0, rs.n_reads, 40):
        quals[rs.offsets[r]: rs.offsets[r + 1]: 6] = 2
    return ReadSet(codes=rs.codes, offsets=rs.offsets, quals=quals, bc=rs.bc, bci=rs.bci,
                   barcoded=rs.barcoded)


@pytest.fixture(scope="module")
def world():
    """{layout: (readset, its graph)}: the small readset as sequenced
    (uniform, 150 bases) and cut as ingest cuts 10x R1 (127 / 150)."""
    rs = with_bad_bases(datasets.simulate(datasets.SMALL, datasets.SMALL_SEED))
    out = {}
    for layout, r in (("uniform", rs), ("r1trim", datasets.r1_trimmed(rs))):
        table = kcount.count_readset(r, "cpu")
        out[layout] = (r, graph.from_device(build.build_graph(table), table))
    return out


@pytest.fixture(autouse=True)
def empty_log():
    st.clear_spans()
    yield
    st.clear_spans()


def good_length(q: np.ndarray) -> int:
    """The longest prefix whose last K qualities are all >= MIN_QUAL (0 if
    none), read by read."""
    run = 0
    best = 0
    for i, ok in enumerate(q >= kcount.MIN_QUAL):
        run = run + 1 if ok else 0
        if run >= K:
            best = i + 1
    return best


def starts(lengths) -> int:
    return sum(max(int(n) - K + 1, 0) for n in lengths)


def layout_rows(nb: int, lengths: np.ndarray) -> int:
    """Sort or query rows of a block of nb flat bases (padding included) of
    reads of these lengths: a uniform block cuts each read's last K-1."""
    if (lengths == lengths[0]).all():
        rl = int(lengths[0])
        return kcount._round_up(nb, rl * 128) // rl * (rl - K + 1)
    return kcount._round_up(nb, kcount.BASE_BUCKET)


def root_counters(root: str) -> dict:
    (entry,) = [s for s in st.spans() if s["name"] == root]
    return {k: entry[k] for k in ROW_COUNTERS}


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.mark.parametrize("layout", ["uniform", "r1trim"])
@pytest.mark.parametrize("blocked", [False, True])
def test_sort_rows_of_the_count_equal_a_numpy_count(world, layout, blocked):
    rs, _ = world[layout]
    assert (rs.lengths()[0::2] == (127 if layout == "r1trim" else 150)).all()
    glen = np.array([good_length(rs.quals[rs.offsets[r]: rs.offsets[r + 1]])
                     for r in range(rs.n_reads)])
    min_len = K + 1
    assert (glen < min_len).any() and ((glen >= min_len) & (glen < rs.lengths())).any()
    mp = int(rs.offsets[-1]) // 2 + 1 if blocked else None
    blocks = kcount.split_readset_blocks(rs, mp) if blocked else [rs]
    assert (len(blocks) >= 2) == blocked
    pad = max(int(b.offsets[-1]) for b in blocks)
    rows = sum(layout_rows(pad, b.lengths()) for b in blocks)
    dead = rows - starts(glen[glen >= min_len])
    traced(lambda: kcount.count_readset(rs, "cpu", max_positions=mp))
    assert root_counters("call.count_readset") == {
        "sort_rows": rows, "dead_sort_rows": dead, "join_rows": 0, "dead_join_rows": 0}
    if layout == "r1trim":  # the trimmed R1 keeps every position as a row
        assert dead / rows > 0.3
    if not blocked:  # the rows K4 sorts, and those holding the sentinel
        inp = kcount.prepare_reads(rs, "cpu")
        canon, pk = kcount.occurrence_rows(inp["codes_ext"], inp["pos_read"], inp["glen_pos"],
                                           inp["bc_pos"], inp["uniform_rl"])
        assert (pk.shape[0], int(kc.is_sentinel(canon).sum())) == (rows, dead)


@pytest.mark.parametrize("layout", ["uniform", "r1trim"])
def test_join_rows_of_the_blocked_pather_equal_a_numpy_count(world, layout):
    rs, bg = world[layout]
    nb = int(rs.offsets[-1])
    mp = next(m for m in range(nb // 2, nb, nb // 50)
              if len(kcount.split_readset_blocks(rs, m)) == 2)
    blocks = kcount.split_readset_blocks(rs, mp)
    pad = max(int(b.offsets[-1]) for b in blocks)
    rows = sum(layout_rows(pad, b.lengths()) for b in blocks)
    dead = rows - starts(rs.lengths())
    calls = []
    with pytest.MonkeyPatch.context() as mpatch:  # the queries the joins are handed
        real = pather._join

        def spy(words, node_edge, node_pos, canon, flipped, invalid):
            calls.append((canon.a.shape[0], int(invalid.sum())))
            return real(words, node_edge, node_pos, canon, flipped, invalid)

        mpatch.setattr(pather, "_join", spy)
        traced(lambda: pather.path_readset(bg, rs, "cpu", max_positions=mp))
    assert root_counters("call.path_readset") == {
        "sort_rows": 0, "dead_sort_rows": 0, "join_rows": rows, "dead_join_rows": dead}
    assert len(calls) == 2 and tuple(map(sum, zip(*calls))) == (rows, dead)
    if layout == "r1trim":  # every position a query, both blocks padded to the larger
        assert calls[0][0] == calls[1][0] == kcount._round_up(pad, kcount.BASE_BUCKET)


def test_without_a_profiler_nothing_is_counted(world, monkeypatch):
    rs, bg = world["r1trim"]
    before = dict(st.COUNTERS)

    def refuse(*a, **kw):
        raise AssertionError("a row count ran with no profiler running")

    monkeypatch.setattr(kcount, "kmer_starts", refuse)
    monkeypatch.setattr(pather, "query_rows", refuse)
    kcount.count_readset(rs, "cpu")
    kcount.count_readset(rs, "cpu", max_positions=int(rs.offsets[-1]) // 2 + 1)
    pather.path_readset(bg, rs, "cpu")
    assert {k: st.COUNTERS[k] for k in ROW_COUNTERS} == {k: before[k] for k in ROW_COUNTERS}
    assert st.spans() == []


SPEC = bench_run.load_spec()
CONFIGS = ROOT / "benchmark" / "configs"


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cells_traffic_gives_its_configurations_read_layout(cell):
    """The generator takes r1_trim from the traffic file; a configuration
    that states a layout is run only with traffic that gives the same one."""
    _, cfg, traffic, _, _ = bench_run.cell_parts(SPEC, cell)
    assert int(traffic.get("r1_trim", 0)) == int(cfg.get("r1_trim", 0))


def test_the_layouts_configuration_is_val10mb_in_every_other_number():
    """val10mb_r1trim is val10mb's readset in the Chromium layout: the same
    generator numbers and cut, r1_trim and its own text beside them."""
    base, trim = (json.loads((CONFIGS / f"{n}.json").read_text())
                  for n in ("val10mb", "val10mb_r1trim"))
    numbers = lambda c: {k: v for k, v in c.items() if isinstance(v, (int, float))}
    assert numbers(trim) == {**numbers(base), "r1_trim": 23}
    assert trim["reduced"] == base["reduced"] and trim["guarantees"] == base["guarantees"]


def small_config() -> dict:
    """val10mb_r1trim cut to a 30 kb genome (the benchmark tests' size)."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "val10mb_r1trim.json").read_text())
    cfg.update(genome_size=30_000, repeats=2, barcodes=40, whitelist_size=128,
               molecule_len=6_000, pairs=3000)
    return cfg


@pytest.mark.parametrize("cell", ["count.val10mb_r1trim", "paths.val10mb_r1trim"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_layouts_cells_run_correct_at_a_small_size(cell, trace, monkeypatch):
    made = []
    real = linked_reads.generate

    def keep(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(linked_reads, "generate", keep)
    res = bench_run.run_cell(cell, 2**31 + 5, 0.2, trace, "cpu", None, small_config())
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) >= {"calls_off"} and len(res["checks"]) >= 2
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    (reads,) = made
    lens = np.diff(reads.offsets)
    assert (lens[0::2] == 127).all() and (lens[1::2] == 150).all()
    assert reads.n_bases == 3000 * 277
    if not trace:
        assert st.spans() == []
        return
    # the window's calls' rows as the reads imply them: one block on the CPU, every position a
    # row, the live ones each read's first length - K + 1 (all qualities >= MIN_QUAL)
    rows = kcount._round_up(reads.n_bases, kcount.BASE_BUCKET)
    live = 3000 * (127 - K + 1 + 150 - K + 1)
    root, kind = (("call.count_readset", "sort") if cell.startswith("count")
                  else ("call.path_readset", "join"))
    roots = [s for s in st.spans() if s["name"] == root]
    assert len(roots) == res["attempted"]
    for s in roots:
        assert (s[f"{kind}_rows"], s[f"dead_{kind}_rows"]) == (rows, rows - live)
