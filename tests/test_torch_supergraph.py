"""The port's supergraph stage against the reference's, on the CPU.

The closure glue (supernova_tpu_torch/parallel/device_nucleate.py) on CPU
tensors, which takes the plain twins of K4 and K2, against the
reference's device glue (JAX on the CPU) and its host core, on the
closure sets of tests/test_device_nucleate.py: the same boundary labels
and the same supergraph D.  Its budget overflow, which sends
nucleate_graph to the host core, and its float32 percentile gate.  Then
Pipeline.stage_supergraph of both packages on the e2e genome of
tests/test_torch_run.py (which takes the closures branch and cleans D):
the same supergraph.npz, dpaths.npz, cpaths.npz, histogram_molecules.json,
stats, lines and molecules, and a resumed stage that returns the same D,
lines and dup.  Every comparison is exact."""
import json
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supernova_tpu.asm import misassembly as rmis
from supernova_tpu.asm import nucleate as rnuc
from supernova_tpu.core import dna as rdna
from supernova_tpu.core.ragged import Ragged as RRagged
from supernova_tpu.dbg.graph import BaseGraph as RBaseGraph
from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.parallel import device_nucleate as rdn
from supernova_tpu.pipeline import run as rrun
from supernova_tpu_torch.asm import closures as pclos
from supernova_tpu_torch.asm import misassembly as pmis
from supernova_tpu_torch.asm import molecules as pmol
from supernova_tpu_torch.asm import nucleate as pnuc
from supernova_tpu_torch.asm import supergraph as psg
from supernova_tpu_torch.parallel import device_nucleate as pdn
from supernova_tpu_torch.pipeline import run as prun

from tests.test_device_nucleate import _d_tuple
from tests.test_nucleate_property import _graph, _random_walks
from tests.test_torch_run import TIMING, e2e_reads
from tests.test_torch_slice import assert_npz_equal

GLUE_KEYS = ("glue_route", "glue_overflow", "glue_positions")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def paranoid():
    """Deep D.validate() in the port's copy too, as tests/conftest.py turns
    it on for the reference's."""
    psg.PARANOID = True
    yield
    psg.PARANOID = False


def short_edge_case(rng):
    """tests/test_device_nucleate.py's short-edge case: a 4-edge chain of
    ~120-base edges (each below the gate, two summing above it) and
    closures that overlap only on short edges."""
    K = 48
    parts = [rng.integers(0, 4, 120).astype(np.uint8) for _ in range(4)]
    seqs = []
    for i, p in enumerate(parts):
        if i:
            p = np.concatenate([seqs[i - 1][-(K - 1):], p])
        seqs.append(p)
    allseqs = seqs + [rdna.revcomp(s) for s in seqs[::-1]]
    ne = len(allseqs)
    bg = RBaseGraph(
        edges=RRagged.from_rows(allseqs, dtype=np.uint8),
        inv=np.array([ne - 1 - i for i in range(ne)], np.int32),
        from_v=np.array([0, 1, 2, 3, 5, 6, 7, 8], np.int32),
        to_v=np.array([1, 2, 3, 4, 6, 7, 8, 9], np.int32), n_vertices=10,
        is_circle=np.zeros(ne, bool),
    )
    closures = [np.array(c, np.int64) for c in ([0, 1, 2], [1, 2, 3], [3], [0])]
    return bg, closures, 100


def glue_case(name):
    """(bg, closures, min_over_bases) of one case of
    tests/test_device_nucleate.py; min_over_bases None is the adaptive
    gate."""
    if name == "short_edge":
        return short_edge_case(np.random.default_rng(0))
    if name == "adaptive":
        rng = np.random.default_rng(0)
        _, bg = _graph(rng, 6000, repeats=3, rep_len=150)
        return bg, _random_walks(rng, bg, 80, max_len=12), None
    rng = np.random.default_rng(int(name))
    _, bg = _graph(rng, 4000, repeats=2, rep_len=150)
    return bg, _random_walks(rng, bg, 50), 100


CASES = ["1", "4", "9", "adaptive", "short_edge"]


@pytest.fixture(scope="module")
def cases():
    return {name: glue_case(name) for name in CASES}


def host_labels(monkeypatch, bg, closures, mob):
    """The port's host core's boundary labels (the parent array it hands
    to _quotient) and its D."""
    got = {}
    quotient = pnuc._quotient

    def spy(bg, cls, cinv, lens, cstart, parent, total):
        got["parent"] = np.asarray(parent)[:total].copy()
        return quotient(bg, cls, cinv, lens, cstart, parent, total)

    monkeypatch.setattr(pnuc, "_quotient", spy)
    D = pnuc.nucleate_graph(bg, closures, min_over_bases=mob, device_glue=False)
    monkeypatch.setattr(pnuc, "_quotient", quotient)
    return got["parent"], D


@pytest.mark.parametrize("name", CASES)
def test_glue_labels_and_D_match_reference_and_host(cases, name, monkeypatch):
    bg, closures, mob = cases[name]
    adaptive = mob is None
    mo = rnuc.MIN_OVER_BASES if adaptive else mob
    cls = rnuc.sanitize_closures(bg, closures)
    info = {}
    got = pdn.glue_closures_device(bg, cls, mo, adaptive, "cpu", info=info)
    want = rdn.glue_closures_device(bg, cls, mo, adaptive)
    assert got is not None and want is not None
    assert info["overflow"] == (0, 0, 0) and info["positions"] == sum(map(len, cls))
    assert min(info["rows"]) > 0
    assert got.dtype == np.int64 and np.array_equal(got, want)
    parent, D_host = host_labels(monkeypatch, bg, closures, mob)
    assert np.array_equal(got, parent)

    ginfo = {}
    D_dev = pnuc.nucleate_graph(bg, closures, min_over_bases=mob, device_glue=True,
                                device="cpu", info=ginfo)
    assert ginfo == {"glue_route": "device", "glue_overflow": (0, 0, 0),
                     "glue_positions": info["positions"]}
    D_ref = rnuc.nucleate_graph(bg, closures, min_over_bases=mob, device_glue=False)
    assert _d_tuple(D_dev) == _d_tuple(D_host) == _d_tuple(D_ref)
    if name == "short_edge":  # the overlap glued: fewer D-edges than closures' chains
        assert D_dev.n_edges < 2 * len(cls)


def test_glue_budget_overflow_takes_the_host_core(cases):
    """Budgets given that clip real work (4P rows an expansion; this set
    needs more): the glue reports the overflow and returns no labels, and
    nucleate_graph takes the host core (route "device_overflow") with the
    host's D.  With no budget the same set glues on the device route."""
    bg, closures, mob = cases["1"]
    cls = rnuc.sanitize_closures(bg, closures)
    P = sum(map(len, cls))
    budgets = (4 * P,) * 3
    info = {}
    assert pdn.glue_closures_device(bg, cls, mob, False, "cpu", info=info,
                                    budgets=budgets) is None
    assert min(info["overflow"]) > 0 and info["rows"] == budgets
    ginfo = {}
    D = pnuc.nucleate_graph(bg, closures, min_over_bases=mob, device_glue=True,
                            device="cpu", info=ginfo, glue_budgets=budgets)
    assert ginfo["glue_route"] == "device_overflow" and ginfo["glue_overflow"] == info["overflow"]
    D_host = rnuc.nucleate_graph(bg, closures, min_over_bases=mob, device_glue=False)
    assert _d_tuple(D) == _d_tuple(D_host)
    info = {}
    assert pdn.glue_closures_device(bg, cls, mob, False, "cpu", info=info) is not None
    assert info["overflow"] == (0, 0, 0) and max(info["rows"]) > 4 * P


def test_gate_is_computed_in_float32():
    """k30_index equals the reference's float32 expression, including at
    candidate counts where a float64 product is one larger or smaller."""
    n = np.arange(1 << 22)
    f32 = (np.maximum(n - 1, 0).astype(np.float32) * np.float32(0.30)).astype(np.int64)
    f64 = (0.30 * np.maximum(n - 1, 0)).astype(np.int64)
    differ = np.nonzero(f32 != f64)[0]
    assert len(differ) > 0
    rng = np.random.default_rng(2)
    picks = np.concatenate([differ[:50], differ[-50:], rng.choice(n, 200), [0, 1, 2, 3]])
    for nc in picks:
        ref = int((jnp.maximum(int(nc) - 1, 0).astype(jnp.float32) * 0.30).astype(jnp.int32))
        assert pdn.k30_index(int(nc)) == ref == f32[nc]
    assert any(pdn.k30_index(int(nc)) != f64[nc] for nc in differ[:50])


def test_device_glue_gate(cases):
    """The gate: CUDA and more than DEVICE_GLUE_MIN_POSITIONS positions in
    plain mode; the CPU and device=None take the host core; device_glue
    without a device raises."""
    bg, closures, mob = cases["4"]
    for device in ("cpu", None):
        info = {}
        pnuc.nucleate_graph(bg, closures, min_over_bases=mob, device=device, info=info)
        assert info["glue_route"] == "host"
    assert pnuc.DEVICE_GLUE_MIN_POSITIONS == 200_000
    with pytest.raises(ValueError):
        pnuc.nucleate_graph(bg, closures, min_over_bases=mob, device_glue=True)


# ------------------------------------------------------------ the stage


def lines_tuple(lines):
    return (tuple(tuple(tuple(tuple(int(e) for e in p) for p in cell.paths)
                        for cell in line.elements) for line in lines.lines),
            tuple(int(x) for x in lines.line_of_edge), tuple(int(x) for x in lines.linv))


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """Both packages from ingest through stage_patch and stage_supergraph
    on the same readset."""
    reads, wl = e2e_reads(np.random.default_rng(0))
    rs = ingest_sim(reads, wl)
    ref_out, port_out = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    ref = rrun.Pipeline(ref_out)
    rs_r = ref.stage_ingest(rs)
    table, rs_r = ref._count_with_cov_guard(rs_r)
    bg_r = ref.stage_graph(table)
    bg_r, rp_r = ref.stage_patch(bg_r, ref.stage_paths(bg_r, rs_r), rs_r)
    want = ref.stage_supergraph(bg_r, rp_r, rs_r)
    ref.stats.dump_json(ref_out / "all_stats.json")
    port = prun.Pipeline(port_out, device="cpu")
    _, bg, rp = port.run_slice(rs)
    bg, rp = port._timed("patch", port.stage_patch, bg, rp, rs)
    got = port._timed("supergraph", port.stage_supergraph, bg, rp, rs)
    return rs, (ref_out, ref, want), (port_out, port, got, bg, rp)


def mols(pipeline):
    return [astuple(m) for m in pipeline._molecules]


def stats_of(out):
    return {k: v for k, v in json.loads((out / "all_stats.json").read_text()).items()
            if not k.startswith(TIMING)}


def test_stage_supergraph_matches_reference(stages):
    _, (ref_out, ref, (D_r, lines_r, dup_r)), (port_out, port, (D, lines, dup), _, _) = stages
    for name in ("supergraph.npz", "dpaths.npz", "cpaths.npz"):
        assert_npz_equal(ref_out / name, port_out / name)
    hist = "stats/histogram_molecules.json"
    assert (port_out / hist).read_text() == (ref_out / hist).read_text()
    assert _d_tuple(D) == _d_tuple(D_r)
    assert lines_tuple(lines) == lines_tuple(lines_r)
    assert np.array_equal(dup, dup_r)
    assert mols(port) == mols(ref) and port._molecules
    assert port._line_positions == ref._line_positions
    assert port._closures == ref._closures
    for a, b in ((port._dpaths, ref._dpaths), (port._dlen, ref._dlen)):
        assert np.array_equal(a, b)
    want, got = stats_of(ref_out), stats_of(port_out)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == set(GLUE_KEYS)
    # the fixture glues closures and cleans D
    assert got["supergraph_mode"] == "closures" and got["super_edges_cleaned"] >= 1
    rec = port.stage_records["supergraph"]
    assert rec["glue_route"] == got["glue_route"] == "host"
    assert rec["glue_overflow"] == (0, 0, 0) and got["glue_overflow"] == 0
    assert rec["glue_positions"] == got["glue_positions"] > 0


def test_stage_closures_glue_on_the_device_route(stages):
    """The stage's closures (cpaths.npz) glued by the device route on CPU
    tensors: the host core's D."""
    _, _, (port_out, _, _, bg, _) = stages
    cl = pclos.load_closures(port_out / "cpaths.npz")
    info = {}
    D_dev = psg.closures_to_graph(bg, cl, device="cpu", info=info)
    assert info["glue_route"] == "host"
    D_glue = pnuc.nucleate_graph(bg, cl, None, device_glue=True, device="cpu", info=info)
    assert info["glue_route"] == "device"
    assert _d_tuple(D_glue) == _d_tuple(D_dev)


def test_resumed_stage_supergraph_reenters(stages, monkeypatch):
    """A resumed stage re-enters from supergraph.npz and dpaths.npz: no
    closure is made or glued, and D, lines, dup and the molecules are the
    fresh stage's."""
    rs, _, (port_out, port, (D, lines, dup), bg, rp) = stages
    fail = lambda *a, **kw: pytest.fail("the stage recomputed on resume")
    monkeypatch.setattr(pclos, "make_closures", fail)
    monkeypatch.setattr(psg, "closures_to_graph", fail)
    resumed = prun.Pipeline(port_out, device="cpu", resume=True)
    D2, lines2, dup2 = resumed.stage_supergraph(bg, rp, rs)
    assert _d_tuple(D2) == _d_tuple(D)
    assert lines_tuple(lines2) == lines_tuple(lines)
    assert np.array_equal(dup2, dup)
    assert mols(resumed) == mols(port)
    assert resumed._closures == port._closures
    assert np.array_equal(resumed._dpaths, port._dpaths)


class LineGraph:
    """The part of a SuperGraph that element_offsets reads: one base edge
    a D-edge, of the given lengths."""

    def __init__(self, lens):
        self.lens = lens
        self.epaths = psg.Ragged.from_rows([[d] for d in range(len(lens))], dtype=np.int64)

    def edge_len(self, d):
        return int(self.lens[d])


@pytest.mark.parametrize("flank,ignore,min_span", [(20_000, 2_000, 2), (600, 0, 1),
                                                   (400, 100, 3), (1_000, 1_000, 2)])
def test_positional_junctions_match_reference(flank, ignore, min_span):
    """The port's find_weak_junctions_positional (sorted windows) finds the
    reference's weak junctions (a scan of every position) on lines of 40
    straight elements, with barcodes whose positions sit around the
    windows' edges, sparse and dense."""
    from supernova_tpu_torch.asm.lines import Cell, Line

    rng = np.random.default_rng(flank)
    n_weak = n_strong = 0
    for _ in range(5):
        D = LineGraph(rng.integers(60, 3_000, 40))
        line = Line([Cell([np.array([d])]) for d in range(40)])
        offs = pmol.element_offsets(D, line)
        edges = np.array([o + d for o in offs for d in (-flank, -ignore, ignore, flank, 0)])
        for n in (3, 8, 20, 40):
            lp = {int(b): sorted((rng.choice(edges, 2)[:, None]
                                  + rng.integers(-2, 3, (2, 3))).ravel().tolist())
                  for b in rng.choice(40, n, replace=False) + 1}
            want = rmis.find_weak_junctions_positional(D, line, lp, min_span, flank, ignore)
            assert pmis.find_weak_junctions_positional(D, line, lp, min_span, flank,
                                                       ignore) == want
            n_weak += len(want)
            n_strong += len(offs) - 2 - len(want)
    assert n_weak > 0 and n_strong > 0
