"""The port's spans and counters (stats/trace.py `span`, the kernel
wrappers' `launches` and `bytes`) on the CPU, and the benchmark's readers
of them on a made-up trace.

Under a torch.profiler session count_readset and path_readset mark their
steps on the profiler's clock and log them with the counters' deltas;
with none running a span is one flag check and the outputs are the same
bits."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run as bench_run
from benchmark import trace as btrace
from supernova_tpu_torch.align import pather
from supernova_tpu_torch.dbg import build, graph
from supernova_tpu_torch.kmer import count as kcount
from supernova_tpu_torch.ops import kernels
from supernova_tpu_torch.ops.kernels import compact as k2
from supernova_tpu_torch.ops.kernels import kmer_extract as k1
from supernova_tpu_torch.ops.kernels import run_reduce as k3
from supernova_tpu_torch.ops.kernels import sort as k4
from supernova_tpu_torch.pipeline import datasets
from supernova_tpu_torch.stats import trace as st

COUNT_STEPS = ["call.count.prep", "call.count.sort", "call.count.reduce", "call.count.recompute"]


@pytest.fixture(scope="module")
def world():
    rs = datasets.simulate(datasets.SMALL, datasets.SMALL_SEED)
    table = kcount.count_readset(rs, "cpu")
    bg = graph.from_device(build.build_graph(table), table)
    return rs, bg


@pytest.fixture(autouse=True)
def empty_log():
    st.clear_spans()
    yield
    st.clear_spans()


def traced(fn):
    """fn() under a CPU profiler -> (its result, the `call.` events as
    (start, end, name) by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                if e.name.startswith("call."))
    return out, ev


def children(events, root):
    """The events inside the one `root` event, by start."""
    (r0, r1, _), = [e for e in events if e[2] == root]
    return [e for e in events if e[2] != root and r0 <= e[0] and e[1] <= r1]


def in_order(events):
    return all(a[1] <= b[0] for a, b in zip(events, events[1:]))


def prepare_reads_h2d(n_reads: int, nb: int, rl: int) -> int:
    """Bytes prepare_reads uploads for n_reads reads of rl bases (nb in
    all): packed codes, read offsets, per-read repeats (int64), lengths,
    good lengths, the barcodes twice (per-read and padded)."""
    nbp = kcount._round_up(nb, rl * 128)
    rp = kcount._round_up(n_reads + 1, kcount.READ_BUCKET)
    return nbp // 4 + (rp + 1) * 4 + (n_reads + 1) * (8 + 4 + 4 + 4) + rp * 4


def test_count_readset_emits_its_steps_in_order(world):
    rs, _ = world
    table, ev = traced(lambda: kcount.count_readset(rs, "cpu"))
    steps = children(ev, "call.count_readset")
    assert [e[2] for e in steps] == COUNT_STEPS and in_order(steps)
    log = st.spans()
    assert [s["name"] for s in log] == COUNT_STEPS + ["call.count_readset"]
    assert [s["parent"] for s in log] == ["call.count_readset"] * 4 + [None]
    assert all(s["device_s"] is None and s["host_end"] >= s["host_start"] for s in log)
    want = prepare_reads_h2d(rs.n_reads, int(rs.offsets[-1]), 150)
    assert log[-1]["h2d_bytes"] == log[0]["h2d_bytes"] == want
    assert all(s["h2d_bytes"] == 0 for s in log[1:4])
    # the CPU runs the kernels' plain twins: no launch, no byte
    assert all(s[f"{k}.{c}"] == 0 for s in log for k in kernels.WRAPPERS
               for c in ("launches", "bytes"))
    assert int(table.n_valid) > 0


def test_blocked_count_emits_each_blocks_steps(world):
    rs, _ = world
    nb = int(rs.offsets[-1])
    _, ev = traced(lambda: kcount.count_readset(rs, "cpu", max_positions=nb // 2 + 1))
    names = [e[2] for e in children(ev, "call.count_readset")]
    blocks = names.count("call.count.prep")
    assert blocks >= 2
    assert names == ["call.count.prep", "call.count.sort", "call.count.reduce"] * blocks + [
        "call.count.reduce", "call.count.recompute"]


@pytest.mark.parametrize("route", ["fused", "general"])
def test_path_readset_emits_prep_join_place_per_block(world, route):
    rs, bg = world
    if route == "general":
        rs = datasets.r1_trimmed(rs)
    nb = int(rs.offsets[-1])
    mp = next(m for m in range(nb // 2, nb, nb // 50)
              if len(kcount.split_readset_blocks(rs, m)) == 2)
    calls = []
    real = pather._path_packed if route == "fused" else pather._path_full

    def spy(*a, **kw):
        calls.append(route)
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(pather, "_path_packed" if route == "fused" else "_path_full", spy)
        out, ev = traced(lambda: pather.path_readset(bg, rs, "cpu", max_positions=mp))
    assert calls == [route] * 2
    steps = children(ev, "call.path_readset")
    block = ["call.paths.prep", "call.paths.join", "call.paths.place"]
    assert [e[2] for e in steps] == ["call.paths.prep"] + block * 2 + ["call.paths.place"]
    assert in_order(steps)
    log = st.spans()
    assert log[-1]["name"] == "call.path_readset" and log[-1]["parent"] is None
    assert sum(s["name"] == "call.paths.prep" for s in log) == 3
    assert log[-1]["h2d_bytes"] == sum(s["h2d_bytes"] for s in log[:-1]) > 0
    if route == "fused":
        blocks = kcount.split_readset_blocks(rs, mp)
        pad = max(int(b.offsets[-1]) for b in blocks)
        assert log[-1]["h2d_bytes"] == 2 * kcount._round_up(pad, 150 * 128) // 4
    untraced = pather.path_readset(bg, rs, "cpu", max_positions=mp)
    assert all(torch.equal(a, b) for a, b in zip(out, untraced))


def test_without_a_profiler_a_span_does_nothing(world, monkeypatch):
    rs, bg = world
    traced_table, _ = traced(lambda: kcount.count_readset(rs, "cpu"))
    traced_paths, _ = traced(lambda: pather.path_readset(bg, rs, "cpu"))
    st.clear_spans()

    def refuse(*a, **kw):
        raise AssertionError("a span did work with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert st.span("call.a") is st.span("call.b", torch.device("cpu"))  # one shared no-op
    table = kcount.count_readset(rs, "cpu")
    paths = pather.path_readset(bg, rs, "cpu")
    assert st.spans() == []
    for a, b in zip((*table.words, *table[1:]), (*traced_table.words, *traced_table[1:])):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(paths, traced_paths))


@pytest.mark.parametrize("m,n", [(1, 0), (1_000_047, 1_000_000), (450_009_728, 450_009_600)])
def test_k1_bytes_are_chip_smokes_bound(m, n):
    assert k1.launch_bytes(m, n) == m * 4 + n * 3 * 8


@pytest.mark.parametrize("rows,keys", [(0, 1), (3_293, 2), (309_006_592, 4), (79_795_908, 3)])
def test_k4_bytes_are_chip_smokes_bound(rows, keys):
    assert k4.launch_bytes(rows, keys) == rows * 8 * (keys + 1)


@pytest.mark.parametrize("rows", [0, 1, 11_845_632, 309_006_592])
def test_k3_bytes_are_chip_smokes_bound(rows):
    assert k3.launch_bytes(rows) == rows * (4 * 8 + 1 + 4 + 4)


@pytest.mark.parametrize("rows,kept,row_bytes", [
    (61_806_592, 2_078_721, 32), (828, 159, 24), (309_006_592, 10_462_765, 32), (5, 0, 8)])
def test_k2_bytes_are_chip_smokes_bound(rows, kept, row_bytes):
    assert k2.launch_bytes(rows, kept, row_bytes, fill=False) == rows + 2 * kept * row_bytes
    assert k2.launch_bytes(rows, kept, row_bytes, fill=True) == (
        rows + kept * row_bytes + rows * row_bytes)


def test_cpu_twins_count_no_launch_and_no_byte(monkeypatch):
    for fn in kernels.WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "bytes", 0)
    monkeypatch.setattr(k2.compact, "kept_bytes", {})
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 4, (1_000,), dtype=torch.int32, generator=g)
    w = k1.sliding_words(codes, 900)
    perm = k4.lex_argsort(*w)
    pk = torch.zeros(900, dtype=torch.int64)
    keep, count, stats = k3.run_reduce(*(x[perm] for x in w), pk, 1, 0)
    k2.compact(keep, count, stats, fills=(0, 0))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    assert kernels.byte_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    assert k2.compact.kept_bytes == {}


def test_kept_bytes_on_the_device_resolve_into_k2s_bytes(monkeypatch):
    monkeypatch.setattr(k2.compact, "bytes", 100)
    monkeypatch.setattr(k2.compact, "kept_bytes", {torch.device("cpu"): torch.tensor(64)})
    snap = kernels.counters()
    monkeypatch.setattr(k2.compact, "kept_bytes", {torch.device("cpu"): torch.tensor(96)})
    assert kernels.resolved(snap)["compact.bytes"] == 164
    assert kernels.byte_counts()["compact"] == 196


# ---------------------------------------------------------- the readers

def fake_world(call, root, steps, kernel_bytes=0, h2d=0, rows=None):
    """Two calls of 1 s under `call`, each with `root` and its `steps` (a
    list of (name, host start, host end, device seconds)), the root
    holding the row counters `rows`; the device busy 0.2 s a call in K4
    and 0.3 s in other work.  -> (Trace, span log)."""
    dev, spans, log = [], {"window": [(0.0, 2.0)], call: [(0.0, 1.0), (1.0, 2.0)]}, []
    for c in (0.0, 1.0):
        dev += [(c + 0.1, c + 0.3, "onesweep_kernel"), (c + 0.3, c + 0.6, "elementwise_kernel")]
        for name, h0, h1, d in steps:
            spans.setdefault(name, []).append((c + h0, c + h1))
            log.append({"name": name, "parent": root, "device_s": d, "h2d_bytes": 0,
                        **{f"{k}.bytes": 0 for k in kernels.WRAPPERS}})
        spans.setdefault(root, []).append((c + 0.01, c + 0.99))
        log.append({"name": root, "parent": None, "device_s": 0.9, "h2d_bytes": h2d,
                    **{f"{k}.bytes": 0 for k in kernels.WRAPPERS}, "sort.bytes": kernel_bytes,
                    **(rows or {})})
    return btrace.Trace((0.0, 2.0), dev, spans), log


COUNT_WORLD = dict(call="call.count", root="call.count_readset", steps=[
    ("call.count.prep", 0.02, 0.3, 0.01), ("call.count.sort", 0.3, 0.5, 0.25),
    ("call.count.reduce", 0.5, 0.6, 0.02), ("call.count.recompute", 0.6, 0.98, 0.4)],
    kernel_bytes=335_000_000, h2d=206_000_000,
    rows={"sort_rows": 436_436_992, "dead_sort_rows": 148_105_852})
PATHS_WORLD = dict(call="call.paths", root="call.path_readset", steps=[
    ("call.paths.prep", 0.02, 0.03, 0.0), ("call.paths.prep", 0.03, 0.2, 0.001),
    ("call.paths.join", 0.2, 0.4, 0.3), ("call.paths.place", 0.4, 0.5, 0.1),
    ("call.paths.prep", 0.5, 0.7, 0.001), ("call.paths.join", 0.7, 0.9, 0.3),
    ("call.paths.place", 0.9, 0.95, 0.1), ("call.paths.place", 0.95, 0.97, 0.01)],
    kernel_bytes=67_000_000, h2d=118_000_000,
    rows={"join_rows": 723_517_440, "dead_join_rows": 435_186_300})
WANT = {
    "prep_s.count": (COUNT_WORLD, 0.28), "sort_s.count": (COUNT_WORLD, 0.25),
    "reduce_s.count": (COUNT_WORLD, 0.02), "recompute_s.count": (COUNT_WORLD, 0.4),
    "h2d_gb.count": (COUNT_WORLD, 0.206),
    # 335 MB at 3.35 TB/s is 0.1 ms, of 0.2 s in K4
    "kernel_roofline.count": (COUNT_WORLD, 0.05),
    "prep_s.paths": (PATHS_WORLD, 0.38), "join_s.paths": (PATHS_WORLD, 0.6),
    "place_s.paths": (PATHS_WORLD, 0.21), "h2d_gb.paths": (PATHS_WORLD, 0.118),
    "kernel_roofline.paths": (PATHS_WORLD, 0.01),
    # the Chromium layout's one count block and two padded pather blocks
    "dead_rows.count": (COUNT_WORLD, 148_105_852 / 436_436_992),
    "dead_rows.paths": (PATHS_WORLD, 435_186_300 / 723_517_440),
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_a_made_up_trace_and_log(metric, monkeypatch):
    world, want = WANT[metric]
    tr, log = fake_world(**world)
    monkeypatch.setattr(st, "spans", lambda: log)
    assert bench_run.reader(metric)(tr) == pytest.approx(want)
    other = PATHS_WORLD if world is COUNT_WORLD else COUNT_WORLD
    assert bench_run.reader(metric)(fake_world(**other)[0]) is None  # no call of its kind


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_nothing_it_cannot_trust(metric, monkeypatch):
    world, _ = WANT[metric]
    tr, log = fake_world(**world)
    read = bench_run.reader(metric)
    monkeypatch.setattr(st, "spans", lambda: log[: len(log) // 2])  # one root for two calls
    assert read(tr) is None
    monkeypatch.setattr(st, "spans", lambda: log)
    tr.device.clear()  # no device event: the CPU's traced run
    assert read(tr) is None
    monkeypatch.delattr(st, "spans")  # a program without the span log
    assert read(fake_world(**world)[0]) is None


@pytest.mark.parametrize("metric", ["dead_rows.count", "dead_rows.paths"])
def test_dead_rows_read_nothing_from_a_program_without_row_counters(metric, monkeypatch):
    world = dict(WANT[metric][0], rows=None)  # the log of a tree before the counters
    tr, log = fake_world(**world)
    monkeypatch.setattr(st, "spans", lambda: log)
    assert bench_run.reader(metric)(tr) is None


def test_span_kernels_gives_each_kernel_to_its_innermost_step():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from supernova_tpu_torch.stats import profile_slice

    def ev(name, s, t, dev=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=s * 1e6, end=t * 1e6))

    scan = "void at::native::tensor_kernel_scan_innermost_dim_with_indices<long>(long*)"
    events = [ev("call.count_readset", 0.0, 10.0), ev("call.count.sort", 1.0, 4.0),
              ev("call.count.recompute", 5.0, 9.0), ev("call.count.sort", 1.0, 4.0, DeviceType.CPU),
              ev(scan, 1.5, 2.0), ev("onesweep_kernel", 2.0, 2.25), ev(scan, 6.0, 7.0),
              ev(scan, 7.0, 8.5), ev("onesweep_kernel", 4.5, 4.75), ev("aten::cummax", 6.0, 7.0,
                                                                         DeviceType.CPU)]
    got = profile_slice.span_kernels(SimpleNamespace(events=lambda: events))
    short = "at::native::tensor_kernel_scan_innermost_dim_with_indices<long>"
    assert got == {"call.count.sort": {short: 0.5, "onesweep_kernel": 0.25},
                   "call.count.recompute": {short: 2.5},
                   "call.count_readset": {"onesweep_kernel": 0.25}}
    lines = profile_slice.span_lines(SimpleNamespace(events=lambda: events), top=1)
    assert lines[0] == f"call.count.recompute: 2.500 s; {short} 2.500"
